"""PyTorch port vs JAX reference: weight import and voice loading.

The same artifacts go through the JAX package's importers and the port's
copies: the reference trees must be identical, leaf for leaf
(``np.array_equal``).  Artifacts: genuine ``torch.onnx.export`` files of
the upstream-VITS module tree (``tests/torch_vits.py``: weight-norm,
constant-folded, weight-norm-removed, multi-speaker), the streaming
voice's ``encoder.onnx`` + ``decoder.onnx`` split, and torch checkpoints
(``.pt``, Lightning ``.ckpt``, ``.pth``).

Then :meth:`PiperVoice.from_config_path` loads one tiny voice from every
layout it resolves (``.npz``, ``.onnx``, the split, ``.pt``, ``.ckpt``,
``.pth``); each port voice's WAV must match the JAX voice's within ±2
int16 LSB at the same length, with the reference's noise (as in
``test_torch_piper.py``).
"""

import json
import shutil
import warnings

import numpy as np
import pytest
import torch

from sonata_tpu.core import FailedToLoadResource as JaxFailedToLoad
from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu.models import import_onnx as jonnx
from sonata_tpu.models import import_torch as jtorch
from sonata_tpu.models.config import ModelConfig
from sonata_tpu.models.serialization import load_params
from sonata_tpu.synth import SpeechSynthesizer as JaxSynthesizer
from sonata_tpu_torch.audio import read_wave_file
from sonata_tpu_torch.core import FailedToLoadResource
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models import import_onnx as tonnx
from sonata_tpu_torch.models import import_torch as ttorch
from sonata_tpu_torch.models.config import ModelConfig as PortModelConfig
from sonata_tpu_torch.models.serialization import flatten_params
from sonata_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from sonata_tpu_torch.synth import SpeechSynthesizer
from sonata_tpu_torch.utils import protowire as tprotowire
from sonata_tpu.utils import protowire as jprotowire
from test_importers import _onnx_bytes
from test_torch_piper import reference_sampler
from torch_vits import TinyPiperVits, export_vits_onnx
from voices import tiny_voice, write_tiny_voice

TEXT = "The quick brown fox jumps over the lazy dog. Hello there!"


def assert_trees_identical(got, want):
    fg, fw = flatten_params(got), flatten_params(want)
    assert fg.keys() == fw.keys()
    for key in fw:
        assert fg[key].dtype == np.asarray(fw[key]).dtype, key
        assert np.array_equal(fg[key], np.asarray(fw[key])), key


@pytest.fixture(scope="module")
def tiny():
    v = tiny_voice()
    return v.hp, v.config.num_symbols


# ---------------------------------------------------------------------------
# genuine torch.onnx.export artifacts
# ---------------------------------------------------------------------------

EXPORTS = {
    "weight_norm": dict(trace_convs=False, fold=False, remove_wn=False),
    "folded": dict(trace_convs=True, fold=True, remove_wn=False),
    "weight_norm_removed": dict(trace_convs=True, fold=True, remove_wn=True),
    "multispeaker": dict(trace_convs=False, fold=False, remove_wn=False,
                         n_speakers=4),
}


@pytest.mark.parametrize("kind", sorted(EXPORTS))
def test_onnx_export_imports_identically(kind, tiny, tmp_path):
    hp, n_vocab = tiny
    opts = dict(EXPORTS[kind])
    n_speakers = opts.pop("n_speakers", 1)
    warnings.filterwarnings("ignore")
    torch.manual_seed(0)
    model = TinyPiperVits(hp, n_vocab, n_speakers=n_speakers,
                          trace_convs=opts.pop("trace_convs"))
    path = tmp_path / f"{kind}.onnx"
    export_vits_onnx(model, path, **opts)
    want = jonnx.import_onnx_weights(path, hp, n_vocab=n_vocab,
                                     n_speakers=n_speakers)
    got = tonnx.import_onnx_weights(path, hp, n_vocab=n_vocab,
                                    n_speakers=n_speakers)
    assert_trees_identical(got, want)
    # the graph walk the CBHG import also relies on
    inits, nodes = tonnx.read_onnx_graph(path)
    j_inits, j_nodes = jonnx.read_onnx_graph(path)
    assert inits.keys() == j_inits.keys()
    assert all(np.array_equal(inits[k], j_inits[k]) for k in inits)
    assert len(nodes) == len(j_nodes) > 0
    for n, jn in zip(nodes, j_nodes):
        assert [n[k] for k in ("op_type", "inputs", "outputs")] == \
            [jn[k] for k in ("op_type", "inputs", "outputs")]
        assert n["attrs"].keys() == jn["attrs"].keys()
        assert all(np.array_equal(np.asarray(n["attrs"][k]),
                                  np.asarray(jn["attrs"][k]))
                   for k in n["attrs"])


def test_recover_folded_conv_weights_matches_reference():
    w = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    inits = {"onnx::Conv_123": w, "dec.conv_pre.bias": np.zeros(4, np.float32)}
    nodes = [{"op_type": "Conv", "attrs": {},
              "inputs": ["x", "onnx::Conv_123", "dec.conv_pre.bias"],
              "outputs": ["y"]}]
    got = tonnx.recover_folded_conv_weights(inits, nodes)
    want = jonnx.recover_folded_conv_weights(inits, nodes)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)


def test_protowire_copy_decodes_like_reference():
    msg = _onnx_bytes({"a.weight": np.arange(6, dtype=np.float32)})
    assert list(tprotowire.iter_fields(msg)) == \
        list(jprotowire.iter_fields(msg))


# ---------------------------------------------------------------------------
# one tiny voice in every layout from_config_path resolves
# ---------------------------------------------------------------------------

def _write_layout(layout: str, src_dir, dst_dir, sd: dict):
    """The tiny voice of ``src_dir`` in ``layout``, in ``dst_dir``;
    returns the config path."""
    cfg = json.loads((src_dir / "voice.onnx.json").read_text())
    tensors = {k: torch.from_numpy(np.ascontiguousarray(x))
               for k, x in sd.items()}
    if layout == "npz":
        shutil.copy(src_dir / "voice.npz", dst_dir / "voice.npz")
    elif layout == "onnx":
        (dst_dir / "voice.onnx").write_bytes(_onnx_bytes(sd))
    elif layout == "split":
        cfg["streaming"] = True
        (dst_dir / "encoder.onnx").write_bytes(_onnx_bytes(
            {k: x for k, x in sd.items() if not k.startswith("dec.")}))
        (dst_dir / "decoder.onnx").write_bytes(_onnx_bytes(
            {k: x for k, x in sd.items() if k.startswith("dec.")}))
    elif layout == "pt":
        torch.save(tensors, dst_dir / "voice.pt")
    elif layout == "ckpt":  # Lightning: the generator under model_g.
        torch.save({"state_dict": {f"model_g.{k}": t
                                   for k, t in tensors.items()},
                    "epoch": 5}, dst_dir / "voice.ckpt")
    elif layout == "pth":
        torch.save({"state_dict": tensors}, dst_dir / "voice.pth")
    config_path = dst_dir / "voice.onnx.json"
    config_path.write_text(json.dumps(cfg))
    return config_path


LAYOUTS = ["npz", "onnx", "split", "pt", "ckpt", "pth"]


@pytest.fixture(scope="module")
def reference_voice(tmp_path_factory):
    """The tiny voice on disk, its state dict, and the JAX voice's WAV."""
    src = tmp_path_factory.mktemp("voice")
    cfg = write_tiny_voice(src, seed=3)
    tree = load_params(src / "voice.npz")
    jax_voice = JaxVoice.from_config_path(cfg)
    sd = {k: np.ascontiguousarray(x, dtype=np.float32)
          for k, x in jtorch.params_to_state_dict(tree, jax_voice.hp).items()}
    try:
        JaxSynthesizer(jax_voice).synthesize_to_file(src / "jax.wav", TEXT)
    finally:
        jax_voice.close()
    return src, tree, sd, read_wave_file(src / "jax.wav")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_voice_loads_from_every_layout_like_reference(layout, reference_voice,
                                                      tmp_path):
    src, tree, sd, (want, want_rate, _) = reference_voice
    cfg = _write_layout(layout, src, tmp_path, sd)
    jax_voice = JaxVoice.from_config_path(cfg)
    port_voice = PiperVoice.from_config_path(
        cfg, device="cpu", sampler=reference_sampler(0))
    try:
        # the JAX voice holds the tree the voice was written from, so its
        # WAV is the reference's from the .npz
        assert_trees_identical(jax_voice.params, tree)
    finally:
        jax_voice.close()
    np.testing.assert_array_equal(port_voice.model["enc_p"]["emb"].numpy(),
                                  tree["enc_p"]["emb"])
    SpeechSynthesizer(port_voice).synthesize_to_file(tmp_path / "port.wav",
                                                     TEXT)
    got, got_rate, _ = read_wave_file(tmp_path / "port.wav")
    assert got_rate == want_rate
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("layout", ["onnx", "split", "pt", "ckpt", "pth"])
def test_importers_give_identical_trees(layout, reference_voice, tmp_path):
    """The port's importer output is the JAX importer's, leaf for leaf, on
    the files each layout holds."""
    src, tree, sd, _ = reference_voice
    cfg = _write_layout(layout, src, tmp_path, sd)
    jcfg = ModelConfig.from_path(cfg)
    shapes = dict(n_vocab=jcfg.num_symbols, n_speakers=1)
    if layout in ("onnx", "split"):
        paths = ((tmp_path / "encoder.onnx", tmp_path / "decoder.onnx")
                 if layout == "split" else tmp_path / "voice.onnx")
        want = jonnx.import_onnx_weights(paths, jcfg.hyper, **shapes)
        got = tonnx.import_onnx_weights(paths, jcfg.hyper, **shapes)
    else:
        path = tmp_path / f"voice.{layout}"
        want = jtorch.import_torch_checkpoint(path, jcfg.hyper, **shapes)
        got = ttorch.import_torch_checkpoint(path, jcfg.hyper, **shapes)
    assert_trees_identical(got, want)
    assert_trees_identical(got, tree)


def test_split_layout_refuses_conflicting_weights(reference_voice, tmp_path):
    src, _tree, sd, _ = reference_voice
    cfg = _write_layout("split", src, tmp_path, sd)
    enc_key = next(k for k in sd if not k.startswith("dec."))
    dec = {k: x for k, x in sd.items() if k.startswith("dec.")}
    dec[enc_key] = sd[enc_key] + 1.0  # same name, other values
    (tmp_path / "decoder.onnx").write_bytes(_onnx_bytes(dec))
    with pytest.raises(JaxFailedToLoad, match="differs"):
        JaxVoice.from_config_path(cfg)
    with pytest.raises(FailedToLoadResource, match="differs"):
        PiperVoice.from_config_path(cfg, device="cpu")


def test_resolution_order_and_refusal(reference_voice, tmp_path):
    """``.npz`` wins over ``.onnx`` over a checkpoint, as in the JAX
    package; with no weights both refuse with the same text."""
    src, tree, sd, _ = reference_voice
    cfg = _write_layout("pt", src, tmp_path, sd)
    # an .onnx beside the .pt, with other weights: it must win
    other = dict(sd, **{"enc_p.emb.weight": sd["enc_p.emb.weight"] * 2})
    (tmp_path / "voice.onnx").write_bytes(_onnx_bytes(other))
    voice = PiperVoice.from_config_path(cfg, device="cpu")
    np.testing.assert_array_equal(voice.model["enc_p"]["emb"].numpy(),
                                  other["enc_p.emb.weight"])
    shutil.copy(src / "voice.npz", tmp_path / "voice.npz")
    voice = PiperVoice.from_config_path(cfg, device="cpu")
    np.testing.assert_array_equal(voice.model["enc_p"]["emb"].numpy(),
                                  sd["enc_p.emb.weight"])
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "voice.onnx.json").write_text(cfg.read_text())
    with pytest.raises(JaxFailedToLoad) as want:
        JaxVoice.from_config_path(empty / "voice.onnx.json")
    with pytest.raises(FailedToLoadResource) as got:
        PiperVoice.from_config_path(empty / "voice.onnx.json", device="cpu")
    assert str(got.value) == str(want.value)


def test_params_to_numpy_inverts_params_from_numpy(reference_voice):
    """A port voice's parameters go back to the reference tree exactly, so
    the port's ``params_to_state_dict`` writes what the JAX package's
    writes (``chip_smoke.py`` saves a voice this way)."""
    src, tree, sd, _ = reference_voice
    hp = PortModelConfig.from_path(src / "voice.onnx.json").hyper
    back = params_to_numpy(params_from_numpy(tree, hp))
    assert_trees_identical(back, tree)
    got = ttorch.params_to_state_dict(back, hp)
    assert got.keys() == sd.keys()
    assert all(np.array_equal(got[k], sd[k]) for k in sd)
