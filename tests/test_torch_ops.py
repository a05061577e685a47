"""The PyTorch port's two kernels: the WaveNet gate and the streaming decode
epilogue.

On the CPU, each wrapper takes its plain PyTorch version; those are held
here against the JAX package — the gate against ``fused_gate_reference``
and the Pallas kernel in interpret mode, the epilogue against the ``lax``
arm and the Pallas arm (interpret mode on a CPU backend).  The CUDA
kernels themselves are held against the plain versions by the tests marked
``cuda``, which skip on a host without a GPU (and by ``chip_smoke.py``).

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests run on a GPU host without jax:
``python -m pytest tests/test_torch_ops.py --noconftest -m cuda``.

Tolerances:
- gate: atol 1e-6 (two transcendentals in float32);
- epilogue: peak rtol 1e-6; int16 within ±1 LSB, with at most 0.1% of the
  samples differing (sin/cos and the float→int truncation can land on the
  other side of an integer).
"""

import numpy as np
import pytest
import torch

from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import decode_opts as tdo
from sonata_tpu_torch.ops import _build
from sonata_tpu_torch.ops.gate import fused_gate, fused_gate_reference

FADE = 42


@pytest.fixture
def cuda():
    """The GPU, or a skip on hosts without one (decided per test, never at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel runs only on the card")
    return torch.device("cuda")


def _gate_inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 2 * h)).astype(np.float32) * 2
    g = rng.standard_normal((b, 1, 2 * h)).astype(np.float32)
    return x, g


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_g", [True, False], ids=["g", "no_g"])
@pytest.mark.parametrize("b,t,h", [(2, 100, 32), (2, 37, 24)])
def test_gate_plain_matches_jax_reference_and_pallas(b, t, h, with_g):
    import jax.numpy as jnp

    from sonata_tpu.ops.gate import fused_gate_pallas
    from sonata_tpu.ops.gate import fused_gate_reference as jax_gate_reference

    x, g = _gate_inputs(b, t, h, seed=t)
    y = x + g if with_g else x
    got = fused_gate(torch.from_numpy(x),
                     torch.from_numpy(g) if with_g else None).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gate_reference(
        jnp.asarray(y))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.asarray(fused_gate_pallas(
        jnp.asarray(y), interpret=True)), atol=1e-6, rtol=0)


def test_gate_plain_takes_channels_first_views():
    x, g = _gate_inputs(2, 19, 8, seed=1)
    nct = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    got = fused_gate(nct.transpose(1, 2), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), fused_gate_reference(
        torch.from_numpy(x + g)).numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# epilogue
# ---------------------------------------------------------------------------

# rows: whole window (lo = 0, hi = S), interior range >= 2*FADE, range
# shorter than 2*FADE (fades overlap), empty range, tail (hi = S)
S = 512
BOUNDS = [(0, S), (13, 500), (100, 130), (200, 200), (40, S)]


def _epilogue_inputs(seed=7):
    wav = (np.random.default_rng(seed).standard_normal((len(BOUNDS), S))
           .astype(np.float32) * 0.5)
    lo = np.asarray([a for a, _ in BOUNDS], np.int32)
    hi = np.asarray([b for _, b in BOUNDS], np.int32)
    return wav, lo, hi


def _assert_epilogue_close(q, peak, q_ref, peak_ref):
    q, q_ref = np.asarray(q, np.int32), np.asarray(q_ref, np.int32)
    np.testing.assert_allclose(np.asarray(peak), np.asarray(peak_ref),
                               rtol=1e-6, atol=0)
    lsb = np.abs(q - q_ref)
    assert lsb.max() <= 1
    assert (lsb > 0).sum() <= 0.001 * q.size


@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_epilogue_plain_matches_jax_arms(mode):
    import jax.numpy as jnp

    from sonata_tpu.models import decode_opts as jdo

    wav, lo, hi = _epilogue_inputs()
    q_ref, peak_ref = jdo.fused_epilogue(jnp.asarray(wav), jnp.asarray(lo),
                                         jnp.asarray(hi), FADE, mode=mode)
    q, peak = tdo.fused_epilogue(torch.from_numpy(wav), torch.from_numpy(lo),
                                 torch.from_numpy(hi), FADE)
    assert q.dtype == torch.int16 and tuple(q.shape) == wav.shape
    _assert_epilogue_close(q.numpy(), peak.numpy(), q_ref, peak_ref)
    # the empty row is all zeros and its peak is 0
    assert not q.numpy()[3].any() and float(peak[3]) == 0.0


def test_epilogue_dequantize_matches_host_crossfade():
    from sonata_tpu_torch.audio import AudioSamples

    wav, lo, hi = _epilogue_inputs(seed=3)
    q, peak = tdo.fused_epilogue(torch.from_numpy(wav), torch.from_numpy(lo),
                                 torch.from_numpy(hi), FADE)
    for i, (a, b) in enumerate(BOUNDS):
        got = tdo.dequantize_chunk(q[i].numpy(), peak[i])[a:b]
        want = AudioSamples(wav[i, a:b]).crossfade(FADE).data
        tol = max(float(peak[i]), 0.01) / 32767.0  # one int16 grid step
        assert got.shape == want.shape
        assert np.abs(got - want).max(initial=0.0) <= tol + 1e-7


def test_resolve_fused_epilogue_modes():
    assert tdo.resolve_fused_epilogue(env={}) == "fused"
    assert tdo.resolve_fused_epilogue("off") == "off"
    assert tdo.resolve_fused_epilogue("fused") == "fused"
    # the JAX package's names for its fused arms are aliases of "fused"
    assert tdo.resolve_fused_epilogue(env={tdo.FUSED_EPILOGUE_ENV: "PALLAS"}) \
        == "fused"
    assert tdo.resolve_fused_epilogue("lax") == "fused"
    with pytest.raises(OperationError):
        tdo.resolve_fused_epilogue("fast")


# ---------------------------------------------------------------------------
# wrappers on the CPU: the plain version, no launch counted
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    gate_before = fused_gate.launches
    epi_before = tdo.fused_epilogue.launches
    x, g = _gate_inputs(1, 8, 4, seed=2)
    fused_gate(torch.from_numpy(x), torch.from_numpy(g))
    wav, lo, hi = _epilogue_inputs()
    tdo.fused_epilogue(torch.from_numpy(wav), torch.from_numpy(lo),
                       torch.from_numpy(hi), FADE)
    assert fused_gate.launches == gate_before == 0
    assert tdo.fused_epilogue.launches == epi_before == 0


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(OperationError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = _build._build_key()
    assert key == _build._build_key() and len(key) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._build_key() != key


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (GPU hosts only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,with_g", [(4, 512, 192, True),
                                           (2, 37, 24, False)])
def test_gate_kernel_matches_plain(cuda, b, t, h, with_g):
    x, g = _gate_inputs(b, t, h, seed=5)
    # the [B, T, 2H] view of a contiguous [B, 2H, T], as wn passes it
    xt = torch.from_numpy(x).to(cuda).transpose(1, 2).contiguous()
    xt = xt.transpose(1, 2)
    gt = torch.from_numpy(g).to(cuda) if with_g else None
    before = fused_gate.launches
    out = fused_gate(xt, gt)
    torch.cuda.synchronize()
    assert fused_gate.launches == before + 1
    ref = fused_gate_reference(xt if gt is None else xt + gt)
    # the result is the same kind of view, of a contiguous [B, H, T]
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)


@pytest.mark.cuda
def test_gate_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((2, 6, 8), device=cuda).transpose(1, 2)
    with pytest.raises(OperationError):
        fused_gate(x.double())
    with pytest.raises(OperationError):
        fused_gate(x.contiguous())  # channels last
    with pytest.raises(OperationError):
        fused_gate(x[:, ::2])  # not a view of a contiguous [B, 2H, T]
    with pytest.raises(OperationError):
        fused_gate(x, torch.zeros((2, 1, 4), device=cuda))


@pytest.mark.cuda
def test_epilogue_kernel_matches_plain(cuda):
    wav, lo, hi = _epilogue_inputs(seed=9)
    args = [torch.from_numpy(a).to(cuda) for a in (wav, lo, hi)]
    before = tdo.fused_epilogue.launches
    q, peak = tdo.fused_epilogue(*args, FADE)
    torch.cuda.synchronize()
    assert tdo.fused_epilogue.launches == before + 1
    q_ref, peak_ref = tdo.fused_epilogue_reference(*args, FADE)
    _assert_epilogue_close(q.cpu().numpy(), peak.cpu().numpy(),
                           q_ref.cpu().numpy(), peak_ref.cpu().numpy())
