"""PyTorch port vs JAX reference: Arabic diacritization.

- The transformer tagger (``models/tashkeel.py``): logits within atol 1e-5
  of ``apply_tashkeel`` at the text bucket, on random weights and on the
  bundled real weights; the bundled tagger's strings identical to the JAX
  ``TashkeelModel``'s.
- The CBHG tagger (``models/tashkeel_cbhg.py``): logits within atol 1e-5 of
  ``apply_cbhg`` on genuine ``torch.onnx.export`` fixtures of
  ``tests/torch_cbhg.py`` (name-preserving and constant-folded, and the
  ``pre_highway`` variant), at the exact length and padded with
  ``lengths``; whitespace chunking of long input with identical strings.
- The engine (``text/tashkeel.py``): identical rule-engine output, the
  same routing and refusals, and an ``ar`` voice diacritizing through it
  exactly as the JAX voice does.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonata_tpu.text.tashkeel as jtk
import sonata_tpu_torch.text.tashkeel as ttk
from sonata_tpu.models import tashkeel as jtag
from sonata_tpu.models import tashkeel_cbhg as jcbhg
from sonata_tpu.text import tashkeel_rules as jrules
from sonata_tpu_torch.core import FailedToLoadResource, OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models import tashkeel as ttag
from sonata_tpu_torch.models import tashkeel_cbhg as tcbhg
from sonata_tpu_torch.text import tashkeel_rules as trules
from torch_cbhg import CBHGTagger, export_onnx
from voices import TINY_MODEL, tiny_voice

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5

# the Arabic sentences of tests/test_tashkeel.py, and two with digits and
# punctuation
SENTENCES = ["مرحبا بالعالم", "السلام عليكم", "مرحبا", "الشمس والقمر",
             "كتاب", "مرحبا بالعالم العربي", "abc 123",
             "ذهب الولد إلى المدرسة، وقرأ 3 كتب.",
             "هل تتكلم العربية؟ نعم، قليلا!"]


def _port_hp(hp):
    return ttag.TashkeelHyperParams(**dataclasses.asdict(hp))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def bundled():
    jax_model = jtag.TashkeelModel.from_path(
        REPO / "sonata_tpu" / "data" / "tashkeel_default.npz")
    port_model = ttag.TashkeelModel.from_path(ttk.BUNDLED_MODEL, device="cpu")
    return jax_model, port_model


_apply_tashkeel = jax.jit(jtag.apply_tashkeel, static_argnums=1)
_apply_cbhg = jax.jit(jcbhg.apply_cbhg)


def _tagger_logits_match(jax_model, port_model, base: str):
    ids = [port_model._char_to_id.get(ch, 0) for ch in base]
    padded = np.zeros((1, 16 * ((len(ids) + 15) // 16)), np.int32)
    padded[0, :len(ids)] = ids
    want = np.asarray(_apply_tashkeel(
        jax_model.params, jax_model.hp, jnp.asarray(padded),
        jnp.asarray([len(ids)], jnp.int32)))[0, :len(ids)]
    got = port_model.logits(base).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bundled_copy_is_byte_identical():
    assert ttk.BUNDLED_MODEL.read_bytes() == (
        REPO / "sonata_tpu" / "data" / "tashkeel_default.npz").read_bytes()
    text = (REPO / "pyproject.toml").read_text(encoding="utf-8")
    assert '"sonata_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh", ' \
        '"data/*.npz"]' in text


@pytest.mark.parametrize("text", SENTENCES[5:8])
def test_bundled_tagger_logits_match_reference(bundled, text):
    jax_model, port_model = bundled
    assert sum(p.numel() for p in port_model.module.parameters()) == 383568
    _tagger_logits_match(jax_model, port_model,
                         ttag.strip_diacritics(text))


def test_random_tagger_logits_match_reference():
    hp = jtag.TashkeelHyperParams(hidden=32, filter=64, n_heads=2,
                                  n_layers=2, window=4)
    jax_model = jtag.TashkeelModel.random(hp, seed=1)
    port_model = ttag.TashkeelModel(_numpy_tree(jax_model.params),
                                    _port_hp(hp), device="cpu")
    for text in SENTENCES[4:8]:
        base = ttag.strip_diacritics(text)
        _tagger_logits_match(jax_model, port_model, base)
        assert port_model.diacritize(text) == jax_model.diacritize(text)


@pytest.mark.parametrize("text", SENTENCES)
def test_bundled_tagger_diacritizes_like_reference(bundled, text):
    jax_model, port_model = bundled
    assert port_model.diacritize(text) == jax_model.diacritize(text)
    long_text = " ".join([text] * 12)  # a larger text bucket
    assert port_model.diacritize(long_text) == jax_model.diacritize(long_text)


def test_tagger_refuses_unreadable_archive(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(FailedToLoadResource, match="cannot load"):
        ttag.TashkeelModel.from_path(bad, device="cpu")


# ---------------------------------------------------------------------------
# CBHG
# ---------------------------------------------------------------------------

SEQ = 21


@pytest.fixture(scope="module")
def cbhg_exports(tmp_path_factory):
    warnings.filterwarnings("ignore")
    d = tmp_path_factory.mktemp("cbhg")
    torch.manual_seed(0)
    model = CBHGTagger()
    export_onnx(model, d / "nofold.onnx", seq_len=SEQ, fold=False)
    export_onnx(model, d / "fold.onnx", seq_len=SEQ, fold=True)
    torch.manual_seed(3)
    export_onnx(CBHGTagger(projections=(24, 12)), d / "pre_highway.onnx",
                seq_len=SEQ, fold=True)
    # the fixtures' 40-row embedding: a sidecar folds the default vocab
    # into it, as a real artifact's own input_id_map would
    sidecar = {"input_id_map": {c: 1 + i % 39 for i, c in
                                enumerate(jtag._DEFAULT_VOCAB)}}
    (d / "nofold.json").write_text(json.dumps(sidecar), encoding="utf-8")
    return d


def _cbhg_logits(params, ids, lengths):
    return np.asarray(_apply_cbhg(params, jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(lengths, jnp.int32)))


@pytest.mark.parametrize("name", ["nofold", "fold", "pre_highway"])
def test_cbhg_logits_match_reference(cbhg_exports, name):
    path = cbhg_exports / f"{name}.onnx"
    jax_tree = jcbhg.cbhg_from_onnx(path)
    port_tree = tcbhg.cbhg_from_onnx(path)
    # the port's import yields the JAX tree, leaf for leaf
    flat_j = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_t = jax.tree_util.tree_leaves_with_path(port_tree)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    assert all(np.array_equal(np.asarray(a), b)
               for (_, a), (_, b) in zip(flat_j, flat_t))
    if name == "pre_highway":
        assert port_tree["pre_highway"] is not None
    module = tcbhg.CBHGTagger(port_tree).eval()
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 40, size=(3, 40))
    lengths = np.array([40, 23, 1])
    want = _cbhg_logits(jax_tree, ids, lengths)
    with torch.no_grad():
        padded = module(torch.from_numpy(ids),
                        torch.from_numpy(lengths)).numpy()
        exact = [module(torch.from_numpy(ids[b:b + 1, :n])).numpy()[0]
                 for b, n in enumerate(lengths)]
    np.testing.assert_allclose(padded, want, atol=ATOL, rtol=0)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(exact[b], want[b, :n], atol=ATOL, rtol=0)


ARABIC = "مرحبا بالعالم العربي"


@pytest.fixture(scope="module")
def cbhg_models(cbhg_exports):
    """Both wrappers over the folded export, with a sidecar whose maps
    cover the text and every class, and a small ``max_len``."""
    chars = sorted(set(ARABIC + "".join(SENTENCES)))
    sidecar = {"input_id_map": {c: 1 + i % 39 for i, c in enumerate(chars)},
               "target_id_map": {d: i for i, d in enumerate(jtag.DIACRITICS)},
               "max_len": 12}
    path = cbhg_exports / "fold.onnx"
    (cbhg_exports / "fold.json").write_text(json.dumps(sidecar),
                                            encoding="utf-8")
    return (jcbhg.TashkeelCBHGModel.from_path(path),
            tcbhg.TashkeelCBHGModel.from_path(path, device="cpu"))


@pytest.mark.parametrize("text", [ARABIC, " ".join([ARABIC] * 8),
                                  "بالعالمالعربيالكبيرجدا", SENTENCES[7]])
def test_cbhg_wrapper_chunks_like_reference(cbhg_models, text):
    jax_model, port_model = cbhg_models
    got = port_model.diacritize(text)
    assert got == jax_model.diacritize(text)
    assert ttag.strip_diacritics(got) == ttag.strip_diacritics(text)
    assert len(got) > len(text)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_rule_engine_matches_reference():
    eng = ttk.TashkeelEngine()
    assert not eng.has_model and eng.model is None
    gold = [ln.strip() for ln in (REPO / "tools" / "tashkeel_gold.txt")
            .read_text(encoding="utf-8").splitlines() if ln.strip()]
    for text in SENTENCES + [jtag.strip_diacritics(g) for g in gold]:
        want = jtk.TashkeelEngine().diacritize(text)
        assert eng.diacritize(text) == want
        assert trules.diacritize(text) == jrules.diacritize(text)


def test_engine_routes_and_refuses(cbhg_exports, tmp_path):
    eng = ttk.TashkeelEngine(str(cbhg_exports / "fold.onnx"), device="cpu")
    assert isinstance(eng.model, tcbhg.TashkeelCBHGModel)
    eng = ttk.TashkeelEngine(str(ttk.BUNDLED_MODEL), device="cpu")
    assert isinstance(eng.model, ttag.TashkeelModel)
    with pytest.raises(FailedToLoadResource, match="ORT-format"):
        ttk.TashkeelEngine(str(tmp_path / "model.ort"), device="cpu")
    # the default vocab reaches id 81; the fixture's embedding has 40 rows
    with pytest.raises(FailedToLoadResource, match="40 rows"):
        ttk.TashkeelEngine(str(cbhg_exports / "pre_highway.onnx"),
                           device="cpu")
    garbage = tmp_path / "garbage.onnx"
    garbage.write_bytes(b"\x00\x01garbage")
    with pytest.raises(FailedToLoadResource):
        ttk.TashkeelEngine(str(garbage), device="cpu")


def test_default_engine_resolution(monkeypatch, tmp_path):
    """Unset: the rule engine, needing no device.  ``bundled``: the
    port's own copy of the bundled tagger.  An unreadable explicit model
    raises; a model asks for the device it runs on."""
    monkeypatch.setattr(ttk, "_ENGINES", {})
    monkeypatch.delenv("SONATA_TASHKEEL_MODEL", raising=False)
    assert not ttk.get_default_engine().has_model  # no CUDA needed
    monkeypatch.setattr(ttk, "_ENGINES", {})
    monkeypatch.setenv("SONATA_TASHKEEL_MODEL", "bundled")
    eng = ttk.get_default_engine(device="cpu")
    assert eng.has_model and eng.model.device.type == "cpu"
    assert ttk.get_default_engine(device="cpu") is eng
    if not torch.cuda.is_available():
        with pytest.raises(OperationError, match="CUDA"):
            ttk.get_default_engine()
    monkeypatch.setattr(ttk, "_ENGINES", {})
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"nope")
    monkeypatch.setenv("SONATA_TASHKEEL_MODEL", str(bad))
    with pytest.raises(FailedToLoadResource):
        ttk.get_default_engine(device="cpu")
    monkeypatch.setattr(ttk, "_ENGINES", {})


def test_ar_voice_chain_uses_engine(cbhg_exports, monkeypatch):
    """An ``ar`` voice gets the default engine on its own device and
    diacritizes (digits expanded first) before G2P, exactly as the JAX
    voice does (reference: piper/src/lib.rs:63-77,270-281)."""
    model = str(cbhg_exports / "nofold.onnx")
    monkeypatch.setenv("SONATA_TASHKEEL_MODEL", model)
    monkeypatch.setattr(ttk, "_ENGINES", {})
    monkeypatch.setattr(jtk, "_GLOBAL", None)
    try:
        port_voice = PiperVoice.random(seed=0, device="cpu",
                                       model=dict(TINY_MODEL),
                                       espeak={"voice": "ar"})
        jax_voice = tiny_voice(espeak={"voice": "ar"})
        assert port_voice._tashkeel.has_model
        assert port_voice._tashkeel.model.device.type == "cpu"
        for text in (ARABIC + ".", SENTENCES[7], "عندي 21 قلما و 3 كتب."):
            got = port_voice.phonemize_text(text)
            assert got.sentences == jax_voice.phonemize_text(text).sentences
            assert got.sentences and all(got.sentences)
    finally:
        monkeypatch.setattr(ttk, "_ENGINES", {})
        monkeypatch.setattr(jtk, "_GLOBAL", None)


def test_ar_voice_takes_an_explicit_engine(bundled):
    eng = ttk.TashkeelEngine(str(ttk.BUNDLED_MODEL), device="cpu")
    voice = PiperVoice.random(seed=0, device="cpu", model=dict(TINY_MODEL),
                              espeak={"voice": "ar"}, tashkeel=eng)
    assert voice._tashkeel is eng
    en_voice = PiperVoice.random(seed=0, device="cpu",
                                 model=dict(TINY_MODEL))
    assert en_voice._tashkeel is None
    jax_model, _ = bundled
    text = "ذهب 3 أولاد إلى المدرسة."
    from sonata_tpu.text.rule_g2p import (
        arabic_number_to_words, expand_numbers)
    from sonata_tpu.text import text_to_phonemes as jax_text_to_phonemes

    want = jax_text_to_phonemes(
        jax_model.diacritize(expand_numbers(text, arabic_number_to_words)),
        voice="ar", remove_lang_switch_flags=True)
    assert voice.phonemize_text(text).sentences == want.sentences
