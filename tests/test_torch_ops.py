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
- gate: atol 1e-6 on the CPU, 2e-6 kernel against plain (two
  transcendentals in float32);
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


def _strided_g(g, device="cpu", layers=3, layer=1):
    """``g`` as ``wn`` hands it to the gate: one layer's ``[B, 1, 2H]``
    slice, transposed, of the stacked ``[B, 2H·layers, 1]`` conditioning."""
    b, _, two_h = g.shape
    stacked = torch.zeros((b, two_h * layers, 1), device=device)
    stacked[:, layer * two_h:(layer + 1) * two_h, 0] = torch.from_numpy(
        g[:, 0]).to(device)
    view = stacked[:, layer * two_h:(layer + 1) * two_h].transpose(1, 2)
    assert view.stride() == (two_h * layers, 1, 1)
    return view


def test_gate_plain_takes_a_strided_g_view():
    import jax.numpy as jnp

    from sonata_tpu.ops.gate import fused_gate_reference as jax_gate_reference

    x, g = _gate_inputs(2, 38, 16, seed=4)
    nct = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    got = fused_gate(nct.transpose(1, 2), _strided_g(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gate_reference(
        jnp.asarray(x + g))), atol=1e-6, rtol=0)


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


def test_epilogue_plain_quantizes_with_the_references_true_division():
    """Without fades (fade 0) the gain is exactly 1 inside the range, so the
    plain version and the JAX arm must agree sample for sample: the scale
    32767 / peak is a true division in both."""
    import jax.numpy as jnp

    from sonata_tpu.models import decode_opts as jdo

    wav = (np.random.default_rng(1).standard_normal((8, 4099))
           .astype(np.float32) * 0.5)
    lo = np.zeros(8, np.int32)
    hi = np.full(8, 4099, np.int32)
    q_ref, peak_ref = jdo.fused_epilogue(jnp.asarray(wav), jnp.asarray(lo),
                                         jnp.asarray(hi), 0, mode="lax")
    q, peak = tdo.fused_epilogue(torch.from_numpy(wav), torch.from_numpy(lo),
                                 torch.from_numpy(hi), 0)
    np.testing.assert_array_equal(peak.numpy(), np.asarray(peak_ref))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))


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


@pytest.mark.parametrize("s", [0, 1, 3, 9, 256, 1001, 2048, 2049, 4099,
                               16384, 32768, 65536, 131077])
def test_epilogue_plan_covers_every_sample_once(s):
    for b in (1, 4):
        c, lv, grid = tdo.epilogue_plan(b, s)
        assert 1 <= c <= tdo.EPILOGUE_MAX_CLUSTER and grid == (c, b)
        assert grid[0] % c == 0
        if s >= 16384:
            assert c == tdo.EPILOGUE_MAX_CLUSTER
        # rows start at every phase within a vector when S % 4 != 0
        for head, vector in [(0, True), (1, True), (2, True), (3, True),
                             (0, False)]:
            slices = tdo.epilogue_slices(s, c, lv, head, vector)
            assert len(slices) == c
            covered = np.zeros(s, np.int64)
            for ranges in slices:
                for start, stop in ranges:
                    assert 0 <= start <= stop <= s
                    covered[start:stop] += 1
            assert (covered == 1).all(), (b, head, vector)


# edge rows: S = 1001 (rows start off a vector boundary), S = 256 (fewer
# samples than a block has threads), and [1, 32768] with lo/hi and both
# fades straddling the 4096-sample slice boundaries
EDGE_ROWS = [(1001, [(0, 1001), (37, 990)]), (256, [(10, 250)]),
             (32768, [(4096 - 20, 3 * 4096 + 20), (4096, 8192 + 10)])]


@pytest.mark.parametrize("s,bounds", EDGE_ROWS, ids=["1001", "256", "32768"])
def test_blockwise_peak_over_the_planned_slices_is_the_plain_peak(s, bounds):
    rng = np.random.default_rng(s)
    wav = torch.from_numpy(
        rng.standard_normal((len(bounds), s)).astype(np.float32) * 0.5)
    lo = torch.tensor([a for a, _ in bounds], dtype=torch.int32)
    hi = torch.tensor([b for _, b in bounds], dtype=torch.int32)
    _, peak = tdo.fused_epilogue_reference(wav, lo, hi, FADE)
    c, lv, _ = tdo.epilogue_plan(len(bounds), s)
    for head, vector in [(0, True), (1, True), (3, True), (0, False)]:
        partial = []
        for ranges in tdo.epilogue_slices(s, c, lv, head, vector):
            keep = torch.zeros(s)
            for start, stop in ranges:
                keep[start:stop] = 1.0
            partial.append(tdo.fused_epilogue_reference(
                wav * keep, lo, hi, FADE)[1])
        assert torch.equal(torch.stack(partial).amax(0), peak)


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
@pytest.mark.parametrize("b,t,h,g_mode,offset", [
    (4, 512, 192, "dense", 0),     # the main path's width
    (2, 37, 24, None, 0),          # T % 4 == 1: rows start off a vector
    (2, 37, 24, "dense", 0),
    (2, 38, 24, "dense", 0),       # T % 4 == 2
    (2, 38, 24, None, 0),
    (2, 64, 24, None, 1),          # x at a storage offset
    (4, 384, 192, "strided", 0),   # g as wn passes it
    (2, 38, 24, "strided", 3)])
def test_gate_kernel_matches_plain(cuda, b, t, h, g_mode, offset):
    x, g = _gate_inputs(b, t, h, seed=5)
    # the [B, T, 2H] view of a contiguous [B, 2H, T], as wn passes it
    flat = torch.zeros(offset + x.size, device=cuda)
    xt = flat[offset:].view(b, 2 * h, t)
    xt.copy_(torch.from_numpy(x).to(cuda).transpose(1, 2))
    xt = xt.transpose(1, 2)
    gt = {None: None, "dense": torch.from_numpy(g).to(cuda),
          "strided": _strided_g(g, cuda)}[g_mode]
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
    with pytest.raises(OperationError):  # g's channel stride is not 1
        fused_gate(x, torch.zeros((2, 12, 1), device=cuda)[:, ::2]
                   .transpose(1, 2))


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


@pytest.mark.cuda
def test_epilogue_kernel_refuses_what_it_cannot_take(cuda):
    wav = torch.zeros((2, 300), device=cuda)
    lim = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(OperationError):
        tdo.fused_epilogue(wav.double(), lim, lim + 300, FADE)
    with pytest.raises(OperationError):
        tdo.fused_epilogue(wav, lim.long(), lim + 300, FADE)
    with pytest.raises(OperationError):  # longer than the kernel's table
        tdo.fused_epilogue(wav, lim, lim + 300, tdo.EPILOGUE_MAX_FADE + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,bounds,offset", [
    (1001, [(0, 1001), (37, 990)], 0),
    (256, [(10, 250)], 0),
    (32768, [(4096 - 20, 3 * 4096 + 20), (4096, 8192 + 10)], 0),
    (4099, [(5, 4090), (2000, 2000), (100, 130)], 1)],  # wav off a vector
    ids=["1001", "256", "32768", "4099-offset"])
def test_epilogue_kernel_matches_plain_at_edges(cuda, s, bounds, offset):
    b = len(bounds)
    rng = np.random.default_rng(s)
    flat = torch.zeros(offset + b * s, device=cuda)
    wav = flat[offset:].view(b, s)
    wav.copy_(torch.from_numpy(
        rng.standard_normal((b, s)).astype(np.float32) * 0.5))
    lo = torch.tensor([a for a, _ in bounds], dtype=torch.int32, device=cuda)
    hi = torch.tensor([e for _, e in bounds], dtype=torch.int32, device=cuda)
    q, peak = tdo.fused_epilogue(wav, lo, hi, FADE)
    torch.cuda.synchronize()
    q_ref, peak_ref = tdo.fused_epilogue_reference(wav, lo, hi, FADE)
    _assert_epilogue_close(q.cpu().numpy(), peak.cpu().numpy(),
                           q_ref.cpu().numpy(), peak_ref.cpu().numpy())


@pytest.mark.cuda
def test_kernels_leave_the_current_device_as_they_found_it(cuda):
    target = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    x = torch.zeros((1, 8, 64), device=target).transpose(1, 2)
    fused_gate(x)
    wav = torch.zeros((1, 300), device=target)
    lim = torch.tensor([0], dtype=torch.int32, device=target)
    tdo.fused_epilogue(wav, lim, lim + 300, FADE)
    torch.cuda.synchronize(target)
    assert torch.cuda.current_device() == 0
