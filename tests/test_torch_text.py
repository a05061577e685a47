"""PyTorch port vs JAX reference: the host-side text and planning code the
port keeps its own copy of (G2P in every language the JAX package
registers, number expansion, phoneme ids, chunk plans, buckets).
Everything here must be identical — no tolerance."""

import numpy as np
import pytest

from sonata_tpu.core import PhonemizationError as JaxPhonemizationError
from sonata_tpu.models import chunker as jchunker
from sonata_tpu.models import config as jconfig
from sonata_tpu.text import numerics as jnumerics
from sonata_tpu.text import rule_g2p as jrule
from sonata_tpu.text import text_to_phonemes as jax_text_to_phonemes
from sonata_tpu.utils import buckets as jbuckets
from sonata_tpu_torch.core import PhonemizationError
from sonata_tpu_torch.models import chunker as tchunker
from sonata_tpu_torch.models import config as tconfig
from sonata_tpu_torch.text import get_default_backend, text_to_phonemes
from sonata_tpu_torch.text import numerics as tnumerics
from sonata_tpu_torch.text import rule_g2p as trule
from sonata_tpu_torch.utils import buckets as tbuckets
from test_encodability import _SAMPLES as GOLDEN_SAMPLES
from test_g2p_properties import ALPHABETS

SENTENCES = [
    "Hello world.",
    "The quick brown fox jumps over the lazy dog!",
    "Is this the real life? Is this just fantasy?",
    "Dr. Smith arrived at 5 p.m. on Jan. 3rd, 2024.",
    "It costs $12.50, or about €11 in total.",
    "We sold 1,234,567 units in 1984 — a record.",
    "The temperature dropped to -12.5 degrees.",
    "She finished 21st out of 300 runners.",
    "Mr. and Mrs. Jones live at 42 Baker St. in London.",
    "Wait... what happened; nobody knows: really?",
    "e.g. apples, pears, and i.e. fruit in general.",
    "The framework's quantization was surprisingly mathematical.",
    "Streaming synthesis turns text into audio, chunk by chunk.",
    "Call me at 555 0199 before 10:30.",
    "Two hundred and twenty-two thousand people attended.",
    "I saw it. Then I left. It was I.",
    "Responsibilities include unbelievably careful congratulations.",
    "The 2nd, 3rd and 4th rows were empty.",
    "He said \"hello\" (quietly) and walked away.",
    "Line one.\nLine two is here.\n\nLine three!",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_text_to_phonemes_matches_reference(text):
    got = text_to_phonemes(text, voice="en-us", remove_lang_switch_flags=True)
    want = jax_text_to_phonemes(text, voice="en-us",
                                remove_lang_switch_flags=True)
    assert got.sentences == want.sentences
    assert len(got) > 0


def test_phonemes_to_ids_and_default_map_match_reference():
    assert tconfig.default_phoneme_id_map() == jconfig.default_phoneme_id_map()
    d = {"phoneme_id_map": jconfig.default_phoneme_id_map(),
         "espeak": {"voice": "en-us"}}
    tcfg = tconfig.ModelConfig.from_dict(d)
    jcfg = jconfig.ModelConfig.from_dict(d)
    assert tcfg.hyper.__dict__ == jcfg.hyper.__dict__
    for text in SENTENCES:
        for sentence in text_to_phonemes(text, voice="en-us"):
            probe = sentence + "☃"  # a symbol no map has: dropped
            assert tcfg.phonemes_to_ids_diag(probe) == \
                jcfg.phonemes_to_ids_diag(probe)


def test_plan_chunks_matches_reference_over_a_grid():
    for total in list(range(0, 130)) + [255, 256, 511, 1000, 2049, 5000]:
        for chunk_size in (12, 45, 55, 300):
            for padding in (0, 2, 3):
                got = [(p.win_start, p.win_end, p.trim_left, p.trim_right)
                       for p in tchunker.plan_chunks(total, chunk_size,
                                                     padding)]
                want = [(p.win_start, p.win_end, p.trim_left, p.trim_right)
                        for p in jchunker.plan_chunks(total, chunk_size,
                                                      padding)]
                assert got == want, (total, chunk_size, padding)
    assert tchunker.CROSSFADE_SAMPLES == jchunker.CROSSFADE_SAMPLES


def test_buckets_match_reference():
    for name in ("TEXT_BUCKETS", "FRAME_BUCKETS", "BATCH_BUCKETS"):
        assert getattr(tbuckets, name) == getattr(jbuckets, name)
        for n in range(0, 3 * getattr(jbuckets, name)[-1] + 2, 7):
            assert tbuckets.bucket_for(n, getattr(tbuckets, name)) == \
                jbuckets.bucket_for(n, getattr(jbuckets, name))
    assert tbuckets.pad_to([1, 2], 5) == jbuckets.pad_to([1, 2], 5)


def _outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``("raised", message)``: a refusal must be
    the same refusal in both packages."""
    try:
        return "ok", fn(*args, **kwargs)
    except (PhonemizationError, JaxPhonemizationError) as e:
        return "raised", str(e)


def _phonemes(fn, text, lang):
    kind, out = _outcome(fn, text, voice=lang, remove_lang_switch_flags=True)
    return kind, out.sentences if kind == "ok" else out


def test_rule_backend_refuses_non_english(monkeypatch):
    """An unregistered code is refused as the JAX package refuses it, and
    ``SONATA_G2P_BEST_EFFORT=1`` falls back to the same English rules."""
    if get_default_backend().name != "rule":
        pytest.skip("eSpeak is installed: the rule backend is not in use")
    monkeypatch.delenv("SONATA_G2P_BEST_EFFORT", raising=False)
    with pytest.raises(PhonemizationError, match="'xx'"):
        text_to_phonemes("Guten Tag.", voice="xx")
    assert _phonemes(text_to_phonemes, "Guten Tag.", "xx") == \
        _phonemes(jax_text_to_phonemes, "Guten Tag.", "xx")
    monkeypatch.setenv("SONATA_G2P_BEST_EFFORT", "1")
    got = _phonemes(text_to_phonemes, "Guten Tag, 42 Leute.", "xx")
    assert got[0] == "ok" and got[1]
    assert got == _phonemes(jax_text_to_phonemes, "Guten Tag, 42 Leute.",
                            "xx")


def test_supported_languages_match_reference():
    assert trule.supported_languages() == jrule.supported_languages()
    assert len(trule.supported_languages()) == 44
    assert set(trule.supported_languages()) <= set(ALPHABETS)


def _corpus(lang: str, seed: int) -> list[str]:
    """The language's golden sentences (``test_encodability``'s corpus),
    twenty words drawn from its alphabet with a seeded generator, as
    sentences of five, and a number sentence."""
    rng = np.random.default_rng(seed)
    alphabet = list(ALPHABETS[lang])
    words = ["".join(rng.choice(alphabet, size=rng.integers(1, 10)))
             for _ in range(20)]
    sentences = [" ".join(words[i:i + 5]).capitalize() + "."
                 for i in range(0, 20, 5)]
    sentences.append(f"{words[0].capitalize()} 7, {words[1]} 42 "
                     f"{words[2]} 1984, 3.5 {words[3]} 12345.")
    return GOLDEN_SAMPLES[lang] + sentences


@pytest.mark.parametrize("lang", jrule.supported_languages())
def test_every_language_phonemizes_like_reference(lang, monkeypatch):
    if get_default_backend().name != "rule":
        pytest.skip("eSpeak is installed: the rule backend is not in use")
    monkeypatch.delenv("SONATA_G2P_BEST_EFFORT", raising=False)
    seed = jrule.supported_languages().index(lang)
    n_ok = 0
    for text in _corpus(lang, seed):
        got = _phonemes(text_to_phonemes, text, lang)
        assert got == _phonemes(jax_text_to_phonemes, text, lang), text
        n_ok += got[0] == "ok"
    assert n_ok > 0  # every language phonemizes most of its corpus


NUMERIC_TEXTS = {
    "en": ["pi is 3.14 and 0.5", "the 21st of 300", "in 1984 and 2024",
           "$12.50 or 3 million dollars", "-12.5 degrees", "1,234,567"],
    "de": ["Pi ist 3,14", "am 3. Mai 2024", "Ich sehe 3. Wir gehen.",
           "12,50 € und 7 $", "-4,5 Grad", "1.234.567 Leute"],
    "es": ["pi es 3,14", "el 1º y la 2ª", "en 1984", "12,50 € o 3 $",
           "-4,5 grados", "1.234.567 personas"],
    "fr": ["pi vaut 3,14", "le 1er et le 21e", "en 1984", "12,50 € et 3 $",
           "-4,5 degrés", "1 234 567 personnes"],
}


@pytest.mark.parametrize("lang", sorted(NUMERIC_TEXTS))
def test_numerics_expansions_match_reference(lang):
    want_g = getattr(jnumerics, f"{lang}_grammar")()
    got_g = getattr(tnumerics, f"{lang}_grammar")()
    for text in NUMERIC_TEXTS[lang]:
        assert tnumerics.expand_numerics(text, got_g) == \
            jnumerics.expand_numerics(text, want_g), text


def test_arabic_expand_numbers_matches_reference():
    for text in ("عندي 3 كتب و 21 قلما", "سنة 1984", "0 و 10 و 11 و 12",
                 "99 100 101 250 1000 2024 100000", "-5 و 7"):
        got = trule.expand_numbers(text, trule.arabic_number_to_words)
        assert got == jrule.expand_numbers(text, jrule.arabic_number_to_words)
    for n in list(range(0, 130)) + [999, 1000, 1001, 2024, 12345, 10 ** 6]:
        assert trule.arabic_number_to_words(n) == \
            jrule.arabic_number_to_words(n), n
