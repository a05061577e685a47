"""The port's decoder precision arms against the JAX package's.

- int8 weight-only decoder (``SONATA_DECODE_QUANT=int8``): the port's
  ``quantize_decoder`` gives the JAX function's ``w_q`` and ``w_scale``
  bit for bit, and an int8 decode matches JAX's int8 decode of the same
  ``z`` within atol 1e-4 (float32 on the CPU, as ``test_torch_vits.py``);
- bfloat16 conv stack (``SONATA_COMPUTE_DTYPE=bfloat16``): the port's
  bf16 decode against its own float32 and against JAX's bf16 decode —
  waveform SNR > 25 dB and log-spectral distance < 1 dB, the JAX bars
  (``test_decode_opts.py``, ``test_vits_model.py``), at the tiny width; at
  Piper medium width the reference's own bf16 misses the spectral bar, and
  the port's bf16 lands within 0.5 dB of it;
- the knobs parse as in the JAX package (``test_vits_model.py``,
  ``test_decode_opts.py``): the same settings give the same arm, and a typo
  fails loudly in both.

The weights are the JAX package's ``vits.init_vits`` tiny voice, carried
across with ``params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonata_tpu.core import OperationError as JaxOperationError
from sonata_tpu.models import decode_opts as jdo
from sonata_tpu.models import vits as jv
from sonata_tpu.models.config import VitsHyperParams
from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models import decode_opts as tdo
from sonata_tpu_torch.models import vits as tv
from sonata_tpu_torch.models.piper import resolve_compute_dtype
from sonata_tpu_torch.models.weights import (
    QConv,
    params_from_numpy,
    params_to_numpy,
)
from voices import TINY_MODEL, write_tiny_voice

HP = VitsHyperParams(**TINY_MODEL)
B, F = 2, 64


def _snr_db(ref, x):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(x, np.float64) - ref
    denom = max(float((ref ** 2).mean()), 1e-12)
    return 10 * np.log10(denom / max(float((err ** 2).mean()), 1e-30))


def _lsd_db(ref, x, nfft=512):
    """The JAX test's mean log-magnitude spectral distance (dB)."""
    ref = np.asarray(ref, np.float64).ravel()
    x = np.asarray(x, np.float64).ravel()
    n = (min(len(ref), len(x)) // nfft) * nfft
    r = np.fft.rfft(ref[:n].reshape(-1, nfft) * np.hanning(nfft), axis=1)
    y = np.fft.rfft(x[:n].reshape(-1, nfft) * np.hanning(nfft), axis=1)
    lr = 20 * np.log10(np.maximum(np.abs(r), 1e-8))
    ly = 20 * np.log10(np.maximum(np.abs(y), 1e-8))
    return float(np.sqrt(((lr - ly) ** 2).mean()))


@pytest.fixture(scope="module", params=[1, 4], ids=["single", "multi"])
def setup(request):
    n_speakers = request.param
    params = jv.init_vits(jax.random.PRNGKey(5), HP, n_vocab=40,
                          n_speakers=n_speakers)
    tree = jax.tree_util.tree_map(np.asarray, params)
    z = np.random.default_rng(2).standard_normal(
        (B, F, HP.inter_channels)).astype(np.float32)
    sid = np.asarray([1, 3], np.int32) if n_speakers > 1 else None
    jg = None if sid is None else params["emb_g"][sid][:, None, :]
    return dict(params=params, tree=tree, z=z, sid=sid, jg=jg)


def _port_g(model, s):
    if s["sid"] is None:
        return None
    return tv.speaker_embedding(model, torch.as_tensor(s["sid"],
                                                       dtype=torch.long))


def test_quantize_decoder_bit_equal(setup):
    want = jdo.quantize_decoder(setup["params"]["dec"])
    got = tdo.quantize_decoder(setup["tree"]["dec"])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path
    assert tdo.decoder_is_quantized(got)
    assert not tdo.decoder_is_quantized(setup["tree"]["dec"])
    # idempotent: a quantized tree passes through (replica copies)
    again = tdo.quantize_decoder(got)
    assert again["conv_pre"]["w_q"] is got["conv_pre"]["w_q"]
    # the module carries the same bits, in torch layout, and back
    model = params_from_numpy(dict(setup["tree"], dec=got), HP)
    assert isinstance(model.dec.conv_pre, QConv)
    assert model.dec.conv_pre.w_q.dtype == torch.int8
    assert tdo.decoder_is_quantized(model.dec)
    back = params_to_numpy(model.dec)
    for (path, w), (_, g) in zip(
            flat_w, jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), path


def test_dequantize_decoder_equals_jax(setup):
    q = tdo.quantize_decoder(setup["tree"]["dec"])
    want = jdo.dequantize_decoder(jdo.quantize_decoder(
        setup["params"]["dec"]))
    got = tdo.dequantize_decoder(q)
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), path
    assert tdo.dequantize_decoder(setup["tree"]["dec"]) \
        is setup["tree"]["dec"]


def test_int8_decode_matches_jax_int8(setup):
    """atol 1e-4: the float32 decode of the same dequantized weights."""
    jparams = dict(setup["params"],
                   dec=jdo.quantize_decoder(setup["params"]["dec"]))
    want = jv.decode_with(jparams, HP, setup["z"], g=setup["jg"])
    model = params_from_numpy(
        dict(setup["tree"], dec=tdo.quantize_decoder(setup["tree"]["dec"])),
        HP)
    with torch.inference_mode():
        got = tv.decode_with(model, HP, torch.from_numpy(setup["z"]),
                             g=_port_g(model, setup))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # and int8 against float32: the JAX bars
    f32 = params_from_numpy(setup["tree"], HP)
    with torch.inference_mode():
        ref = tv.decode_with(f32, HP, torch.from_numpy(setup["z"]),
                             g=_port_g(f32, setup)).numpy()
    assert _snr_db(ref, got.numpy()) > 25.0
    assert _lsd_db(ref, got.numpy()) < 1.0


def test_bf16_decode_against_f32_and_jax_bf16(setup):
    model = params_from_numpy(setup["tree"], HP)
    z = torch.from_numpy(setup["z"])
    with torch.inference_mode():
        f32 = tv.decode_with(model, HP, z, g=_port_g(model, setup)).numpy()
        bf16 = tv.decode_with(model, HP, z, g=_port_g(model, setup),
                              compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32  # back to float32 before tanh
    bf16 = bf16.numpy()
    want = np.asarray(jv.decode_with(setup["params"], HP, setup["z"],
                                     g=setup["jg"],
                                     compute_dtype=jnp.bfloat16))
    for ref in (f32, want):
        assert _snr_db(ref, bf16) > 25.0
        assert _lsd_db(ref, bf16) < 1.0


@pytest.fixture(scope="module")
def voice_cfg(tmp_path_factory):
    return write_tiny_voice(tmp_path_factory.mktemp("precision"), seed=24)


@pytest.mark.parametrize("arm", [dict(compute_dtype="bfloat16"),
                                 dict(decode_quant="int8"),
                                 dict(compute_dtype="bf16",
                                      decode_quant="int8")],
                         ids=["bf16", "int8", "bf16+int8"])
def test_voice_arms_against_f32(voice_cfg, arm):
    """A whole voice per arm, same seed: the durations and the flow stay
    float32, so the lengths match and only the decode differs."""
    f32 = PiperVoice.from_config_path(voice_cfg, device="cpu")
    other = PiperVoice.from_config_path(voice_cfg, device="cpu", **arm)
    ph = list(f32.phonemize_text(
        "This sentence checks the reduced precision decoder."))
    a = f32.speak_batch(ph)[0].samples.data
    b = other.speak_batch(ph)[0].samples.data
    assert a.shape == b.shape and np.isfinite(b).all()
    assert _snr_db(a, b) > 25.0
    assert _lsd_db(a, b) < 1.0
    if "decode_quant" in arm:
        assert tdo.decoder_is_quantized(other.model.dec)
    else:
        # one decoder, kept as loaded: the bf16 arm casts at the call
        assert other.compute_dtype == torch.bfloat16
        assert other.model.dec.conv_pre.weight.dtype == torch.float32
        assert not hasattr(other, "_dec")
    # the stream path's decode runs the same arm and hands the epilogue
    # float32
    chunks = [c.samples.data for c in other.stream_synthesis(ph[0], 20, 3)]
    assert chunks and all(np.isfinite(c).all() for c in chunks)
    other.close()
    f32.close()


def test_int8_replica_shares_quantized_params(voice_cfg):
    v = PiperVoice.from_config_path(voice_cfg, device="cpu",
                                    decode_quant="int8",
                                    compute_dtype="bfloat16")
    r = v.replica_for_device("cpu", seed_offset=1)
    assert r.decode_quant == "int8" and r.compute_dtype == torch.bfloat16
    assert r.model.dec.conv_pre.w_q is v.model.dec.conv_pre.w_q
    assert r.fused_epilogue == v.fused_epilogue
    assert r._seed == v._seed + 1
    r.close()
    v.close()


def test_bf16_replica_shares_the_decoder(voice_cfg):
    """A bf16 voice holds one decoder, as loaded; a replica on the same
    device shares it and decodes what the voice does."""
    v = PiperVoice.from_config_path(voice_cfg, device="cpu",
                                    compute_dtype="bfloat16")
    r = v.replica_for_device("cpu", seed_offset=1)
    try:
        assert r.compute_dtype == torch.bfloat16
        assert r.model.dec is v.model.dec
        z = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (1, 16, v.hp.inter_channels)).astype(np.float32))
        with torch.inference_mode():
            a, b = v._decode(z), r._decode(z)
        assert a.dtype == torch.float32 and torch.equal(a, b)
    finally:
        r.close()
        v.close()


def test_compute_dtype_parsing_matches_jax(monkeypatch, voice_cfg):
    monkeypatch.delenv("SONATA_COMPUTE_DTYPE", raising=False)
    for spelling, want in (("bfloat16", torch.bfloat16),
                           ("bf16", torch.bfloat16), ("float32", None),
                           ("f32", None), (None, None), ("", None)):
        assert resolve_compute_dtype(spelling) == want
        got = PiperVoice.from_config_path(voice_cfg, device="cpu",
                                          compute_dtype=spelling)
        assert got.compute_dtype == want
    for bad in ("float16", "fp8"):
        with pytest.raises(OperationError):
            resolve_compute_dtype(bad)
    monkeypatch.setenv("SONATA_COMPUTE_DTYPE", "bfloat16")
    assert PiperVoice.from_config_path(
        voice_cfg, device="cpu").compute_dtype == torch.bfloat16
    monkeypatch.setenv("SONATA_COMPUTE_DTYPE", "half")
    with pytest.raises(OperationError, match="compute_dtype"):
        PiperVoice.from_config_path(voice_cfg, device="cpu")


@pytest.mark.parametrize("setting", ["", "off", "0", "int8", "INT8",
                                     " int8 ", "int4", "on", "fp8"])
def test_decode_quant_parsing_matches_jax(setting):
    env = {tdo.DECODE_QUANT_ENV: setting}
    try:
        want = jdo.resolve_decode_quant(env=env)
    except JaxOperationError:
        with pytest.raises(OperationError, match="SONATA_DECODE_QUANT"):
            tdo.resolve_decode_quant(env=env)
        return
    assert tdo.resolve_decode_quant(env=env) == want
    assert tdo.resolve_decode_quant(setting.strip().lower() or None,
                                    env={}) == want


def test_epilogue_refuses_bfloat16():
    wav = torch.zeros((1, 256), dtype=torch.bfloat16)
    lim = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(OperationError, match="float32"):
        tdo.fused_epilogue(wav, lim, lim + 256, 42)


def test_bf16_spectral_distance_is_the_references_at_medium_width():
    """At Piper medium width the bfloat16 conv stack's noise floor swamps
    the quiet bins of the spectrum: the reference's own bf16 decode sits
    several dB of log-spectral distance from its float32 one, far past the
    int8 arm's 1 dB bar, while its SNR stays above the 25 dB bf16 bar.
    The port's bf16 decode lands where the reference's does: SNR > 25 dB,
    and an LSD within 0.5 dB of the reference's (same weights, same z)."""
    hp = VitsHyperParams()
    params = jv.init_vits(jax.random.PRNGKey(0), hp, n_vocab=64,
                          n_speakers=1)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), hp)
    z = (np.random.default_rng(0).standard_normal(
        (1, 96, hp.inter_channels)) * 0.5).astype(np.float32)
    with torch.inference_mode():
        f32 = tv.decode_with(model, hp, torch.from_numpy(z)).numpy()
        bf16 = tv.decode_with(model, hp, torch.from_numpy(z),
                              compute_dtype=torch.bfloat16).numpy()
    jf32 = np.asarray(jv.decode_with(params, hp, z))
    jbf16 = np.asarray(jv.decode_with(params, hp, z,
                                      compute_dtype=jnp.bfloat16))
    want, got = _lsd_db(jf32, jbf16), _lsd_db(f32, bf16)
    assert want > 1.0  # the reference misses the int8 arm's spectral bar
    assert _snr_db(jf32, jbf16) > 25.0 and _snr_db(f32, bf16) > 25.0
    assert abs(got - want) < 0.5
