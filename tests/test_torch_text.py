"""PyTorch port vs JAX reference: the host-side text and planning code the
port keeps its own copy of (English G2P, phoneme ids, chunk plans,
buckets).  Everything here must be identical — no tolerance."""

import pytest

from sonata_tpu.models import chunker as jchunker
from sonata_tpu.models import config as jconfig
from sonata_tpu.text import text_to_phonemes as jax_text_to_phonemes
from sonata_tpu.utils import buckets as jbuckets
from sonata_tpu_torch.core import PhonemizationError
from sonata_tpu_torch.models import chunker as tchunker
from sonata_tpu_torch.models import config as tconfig
from sonata_tpu_torch.text import get_default_backend, text_to_phonemes
from sonata_tpu_torch.utils import buckets as tbuckets

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


def test_rule_backend_refuses_non_english(monkeypatch):
    if get_default_backend().name != "rule":
        pytest.skip("eSpeak is installed: the rule backend is not in use")
    monkeypatch.delenv("SONATA_G2P_BEST_EFFORT", raising=False)
    with pytest.raises(PhonemizationError, match="'de'"):
        text_to_phonemes("Guten Tag.", voice="de")
