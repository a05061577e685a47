"""The port's device mesh against the unsharded port and the JAX mesh.

Counterparts of ``tests/test_parallel.py``.  A port mesh here is a list of
repeated ``"cpu"`` devices (the schedule runs in full: rows split over the
data axis, lockstep seq lanes with halo and ring exchanges, the decoder's
channels split over the model axis); the JAX side runs on the forced host
devices of ``tests/conftest.py``.

Tolerances:
- the port's mesh voice against the port's unsharded voice: audio within
  2e-4, stages within 2e-5, identical lengths and chunk boundaries (the
  JAX test's own bars);
- the port against the JAX mesh on the same weights, inputs and reference
  draws: stages within 1e-4, WAVs within ±2 int16 LSB, streamed chunks
  within ±1 LSB of the chunk's scale (the parity bars of the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu.parallel import make_mesh as jax_make_mesh
from sonata_tpu.synth import SpeechSynthesizer as JaxSynthesizer
from sonata_tpu_torch.audio import read_wave_file
from sonata_tpu_torch.core import FailedToLoadResource, OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models import modules as tm
from sonata_tpu_torch.models import vits as tvits
from sonata_tpu_torch.parallel import (
    checkpoint,
    initialize_distributed,
    make_mesh,
    param_shardings,
    ring_attention,
)
from sonata_tpu_torch.synth import SpeechSynthesizer
from test_torch_piper import reference_sampler
from voices import write_tiny_voice

CPU8 = ["cpu"] * 8
#: (seq_parallel, model_parallel) over 8 entries: dp, dp+sp, dp+sp+tp
LAYOUTS = {"dp": (1, 1), "dp_sp": (2, 1), "dp_sp_tp": (2, 2)}
BATCH = ["tɛst wʌn.", "tɛst tuː ɪz hɪɹ.", "θɹiː.", "fɔːɹ moːɹ wɜːdz."]
STREAM = "wˈʌn tuː θɹiː fˈoːɹ, faɪv sɪks sˈɛvən."
LONG = " ".join(["wʌn tuː θɹiː fɔːɹ faɪv sɪks"] * 8) + "."
TEXT = "Hello there, mesh. A second sentence rides the data axis."


def port_mesh(seq=1, model=1, n=8):
    return make_mesh(devices=["cpu"] * n, seq_parallel=seq,
                     model_parallel=model)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return write_tiny_voice(tmp_path_factory.mktemp("mesh"), seed=11)


@pytest.fixture
def plain(cfg):
    """The unsharded voice, fresh: its noise counter starts where a new
    mesh voice's does."""
    voice = PiperVoice.from_config_path(cfg, device="cpu", seed=11)
    yield voice
    voice.close()


@pytest.fixture
def exact_jax_frame_bucket(monkeypatch):
    """The JAX voice's frame estimate pinned to the smallest bucket, so its
    retry lands on the exact bucket the port takes."""
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_mesh_shapes_and_errors():
    assert port_mesh().shape == {"data": 8, "seq": 1, "model": 1}
    assert port_mesh(2).shape == {"data": 4, "seq": 2, "model": 1}
    assert port_mesh(2, 2).shape == {"data": 2, "seq": 2, "model": 2}
    for kw in ({"seq_parallel": 2}, {"seq_parallel": 2, "model_parallel": 2}):
        assert port_mesh(**{"seq": kw.get("seq_parallel", 1),
                            "model": kw.get("model_parallel", 1)}).shape \
            == dict(jax_make_mesh(8, **kw).shape)
    with pytest.raises(ValueError):
        make_mesh(devices=["cpu"] * 6, seq_parallel=4)
    with pytest.raises(ValueError):
        make_mesh(devices=CPU8, seq_parallel=2, model_parallel=3)
    with pytest.raises(ValueError, match="only 8 devices"):
        make_mesh(9, devices=CPU8)


def test_mesh_takes_the_visible_cuda_devices_only():
    """No device list is built on the host's behalf: without ``devices=``
    the mesh is over the visible CUDA devices, and it refuses to be larger
    than they are."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available|visible"):
        make_mesh(n + 1)
    if n == 0:
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh()


def test_parameters_are_copied_once_per_distinct_device(plain):
    mesh = port_mesh(2, 2)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert mesh.put(plain.model) is plain.model
    assert mesh.put(plain.model["flow"], torch.device("cpu")) \
        is plain.model["flow"]
    w = plain.model["dec"]["conv_pre"].weight
    s0 = mesh.shard(w, 0, 0, 2, torch.device("cpu"))
    assert s0 is mesh.shard(w, 0, 0, 2, torch.device("cpu"))
    assert torch.equal(torch.cat([s0, mesh.shard(w, 0, 1, 2, s0.device)]), w)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_param_shardings_match_the_reference_leaf_for_leaf(
        cfg, plain, model_parallel):
    from sonata_tpu.parallel import param_shardings as jax_shardings

    jv = JaxVoice.from_config_path(cfg)
    try:
        want = jax_shardings(jax_make_mesh(8, model_parallel=model_parallel),
                             jv.params)
    finally:
        jv.close()
    got = param_shardings(port_mesh(1, model_parallel), plain.model)
    want_leaves = {jax.tree_util.keystr(path): tuple(s.spec)
                   for path, s in jax.tree_util.tree_flatten_with_path(
                       want)[0]}

    def flatten(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from flatten(v, f"{path}['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from flatten(v, f"{path}[{i}]")
        else:
            yield path, node.spec

    got_leaves = dict(flatten(got))
    assert got_leaves == want_leaves
    split = [p for p, s in got_leaves.items() if s]
    assert bool(split) == (model_parallel > 1)
    if model_parallel > 1:
        assert got["dec"]["ups"][0]["w"].dim == 1  # [C_in, C_out, K]
        assert got["dec"]["resblocks"][0]["convs2"][0]["w"].dim == 1
        assert got["dec"]["conv_pre"]["w"].dim == 0


def test_initialize_distributed_is_a_no_op_in_one_process():
    initialize_distributed()
    initialize_distributed("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


def test_a_failing_lane_fails_the_call_without_hanging():
    mesh = port_mesh(4)
    x = torch.zeros(2, 8, 16)

    def boom(sub, x):
        from sonata_tpu_torch.parallel.ring import halo_exchange, split_time

        def lane(xs):
            if xs.device.type == "cpu" and float(xs[0, 0, 0]) == 1.0:
                raise RuntimeError("lane failed")
            return halo_exchange(xs, 1, 1)

        xs = split_time(x, sub.axis_devices("seq"), 2)
        xs[2] = xs[2] + 1.0
        return sub.spmd("seq", lane, [(t,) for t in xs])

    from sonata_tpu_torch.parallel.mesh import map_rows

    with pytest.raises(RuntimeError, match="lane failed"):
        map_rows(mesh, boom, x)
    with pytest.raises(RuntimeError, match="outside an SPMD region"):
        from sonata_tpu_torch.parallel.ring import halo_exchange

        halo_exchange(x, 1, 1)


# ---------------------------------------------------------------------------
# ring attention and the sequence-parallel stages
# ---------------------------------------------------------------------------

def _exact_attention(q, k, v, kv_valid):
    logits = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    logits = logits + torch.where(kv_valid[:, None, None, :] > 0, 0.0, -1e9)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("seq,axis", [(8, "seq"), (4, "seq"), (1, "data")])
def test_ring_attention_matches_exact_and_the_reference(seq, axis):
    from sonata_tpu.parallel import ring_attention as jax_ring

    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
               for _ in range(3))
    lengths = np.array([64, 40], np.int32)
    mesh = port_mesh(seq)
    got = ring_attention(_t(q), _t(k), _t(v), torch.from_numpy(lengths),
                         mesh, axis_name=axis)
    valid = (torch.arange(64)[None, :] < torch.from_numpy(lengths)[:, None])
    np.testing.assert_allclose(
        got.numpy(), _exact_attention(_t(q), _t(k), _t(v), valid.float())
        .numpy(), atol=2e-5)
    want = jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lengths), jax_make_mesh(8, seq_parallel=seq),
                    axis_name=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_seq_parallel_transformer_matches_baseline_and_reference(cfg, plain):
    from sonata_tpu.models import modules as jm

    hp = plain.hp
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 48, hp.hidden_channels)).astype(np.float32)
    lengths = np.array([48, 31, 7, 20])
    mask = (np.arange(48)[None, :] < lengths[:, None]).astype(
        np.float32)[..., None]
    enc = plain.model["enc_p"]["encoder"]
    kw = dict(n_heads=hp.n_heads, window=hp.attn_window)
    with torch.inference_mode():
        base = tm.transformer(_t(x), _t(mask), enc, **kw)
        got = tm.transformer_seq_parallel(_t(x), _t(mask), enc,
                                          mesh=port_mesh(4), **kw)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=2e-5)
    jv = JaxVoice.from_config_path(cfg)
    try:
        want = jm.transformer_seq_parallel(
            jnp.asarray(x), jnp.asarray(mask), jv.params["enc_p"]["encoder"],
            mesh=jax_make_mesh(8, seq_parallel=4), **kw)
    finally:
        jv.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.fixture
def frame_inputs(plain):
    hp = plain.hp
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 64, hp.inter_channels)).astype(np.float32)
    lengths = np.array([64, 29])
    mask = (np.arange(64)[None, :] < lengths[:, None]).astype(
        np.float32)[..., None]
    return z, mask


@pytest.mark.parametrize("seq", [2, 4])
def test_frame_domain_seq_parallel_matches_unsharded_and_reference(
        cfg, plain, frame_inputs, seq):
    from sonata_tpu.models.seq_parallel import (
        decode_sp as jax_decode_sp,
        flow_reverse_sp as jax_flow_sp,
    )
    from sonata_tpu_torch.models.seq_parallel import decode_sp, flow_reverse_sp

    hp, p = plain.hp, plain.model
    z, mask = frame_inputs
    mesh = port_mesh(seq, n=2 * seq)  # data 2: one row per data group
    with torch.inference_mode():
        flow = flow_reverse_sp(p["flow"], hp, _t(z), _t(mask), mesh)
        dec = decode_sp(p, hp, _t(z), mesh)
        np.testing.assert_allclose(
            flow.numpy(), tvits.flow_reverse(p["flow"], hp, _t(z), _t(mask))
            .numpy(), atol=2e-5)
        np.testing.assert_allclose(
            dec.numpy(), tvits.decode_with(p, hp, _t(z)).numpy(), atol=2e-5)
    if seq != 4:
        return  # the reference's own test compiles seq=4 alone
    jv = JaxVoice.from_config_path(cfg)
    try:
        jmesh = jax_make_mesh(2 * seq, seq_parallel=seq)
        jflow = jax_flow_sp(jv.params["flow"], hp, jnp.asarray(z),
                            jnp.asarray(mask), jmesh)
        jdec = jax_decode_sp(jv.params, hp, jnp.asarray(z), jmesh)
    finally:
        jv.close()
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=1e-4)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-4)


def test_decode_sp_bfloat16_matches_unsharded_bfloat16(plain, frame_inputs):
    from sonata_tpu_torch.models.seq_parallel import decode_sp

    z, _mask = frame_inputs
    with torch.inference_mode():
        sharded = decode_sp(plain.model, plain.hp, _t(z), port_mesh(2, n=4),
                            compute_dtype=torch.bfloat16)
        unsharded = tvits.decode_with(plain.model, plain.hp, _t(z),
                                      compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(sharded.numpy(), unsharded.numpy(), atol=2e-5)
    assert np.isfinite(sharded.numpy()).all()


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_tensor_parallel_decoder_matches_unsharded_and_reference(
        cfg, plain, frame_inputs, model_parallel):
    """The hand-placed column/row collectives are numerically transparent:
    the port's model-axis decoder against its own unsharded decoder and
    against the reference's decoder on the same latent."""
    from sonata_tpu.models import vits as jvits

    z, _mask = frame_inputs
    mesh = port_mesh(1, model_parallel, n=2 * model_parallel)
    calls = []
    orig = tvits.decode_tensor_parallel
    with torch.inference_mode():
        try:
            tvits.decode_tensor_parallel = (
                lambda *a, **k: calls.append(1) or orig(*a, **k))
            got = tvits.decode(plain.model, plain.hp, _t(z), mesh=mesh)
        finally:
            tvits.decode_tensor_parallel = orig
        base = tvits.decode_with(plain.model, plain.hp, _t(z))
    assert calls
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=2e-5)
    jv = JaxVoice.from_config_path(cfg)
    try:
        want = jvits.decode(jv.params, plain.hp, jnp.asarray(z))
    finally:
        jv.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# mesh voices: batch and streaming, sharded against unsharded
# ---------------------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Counts of the sharded stages a mesh voice goes through."""
    from sonata_tpu_torch.models import seq_parallel

    calls = {"ring": 0, "flow_sp": 0, "decode_sp": 0, "tp": 0}

    def spy(module, name, key):
        orig = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(tm, "transformer_seq_parallel", "ring")
    spy(seq_parallel, "flow_reverse_sp", "flow_sp")
    spy(seq_parallel, "decode_sp", "decode_sp")
    spy(tvits, "decode_tensor_parallel", "tp")
    return calls


def _expected_paths(layout):
    seq, model = LAYOUTS[layout]
    return {"ring": seq > 1, "flow_sp": seq > 1 and model == 1,
            "decode_sp": seq > 1 and model == 1, "tp": model > 1}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batch_matches_unsharded(cfg, plain, spies, layout):
    mesh = port_mesh(*LAYOUTS[layout])
    vm = PiperVoice.from_config_path(cfg, seed=11, mesh=mesh)
    assert vm.device == torch.device("cpu")
    want = plain.speak_batch(BATCH + [LONG])
    assert not any(spies.values())  # the unsharded voice never shards
    got = vm.speak_batch(BATCH + [LONG])
    vm.close()
    assert {k: v > 0 for k, v in spies.items()} == _expected_paths(layout)
    assert len(want[-1].samples) > 3000  # the long one spans the shards
    for w_, g_ in zip(want, got):
        assert len(w_.samples) == len(g_.samples) > 0
        np.testing.assert_allclose(g_.samples.data, w_.samples.data,
                                   atol=2e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_stream_matches_unsharded(cfg, plain, spies, layout):
    mesh = port_mesh(*LAYOUTS[layout])
    vm = PiperVoice.from_config_path(cfg, seed=11, mesh=mesh)
    want = list(plain.stream_synthesis(STREAM, 12, 2))
    got = list(vm.stream_synthesis(STREAM, 12, 2))
    vm.close()
    assert spies["ring"] == 0 or LAYOUTS[layout][0] > 1
    assert [len(c.samples) for c in got] == [len(c.samples) for c in want]
    assert len(got) > 2
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(g_.samples.data, w_.samples.data,
                                   atol=2e-4)


def test_sharded_batch_pads_to_the_data_axis(cfg):
    vm = PiperVoice.from_config_path(cfg, seed=3, mesh=port_mesh())
    audios = vm.speak_batch(["tɛst."])  # 1 sentence → 8 rows
    assert len(audios) == 1 and len(audios[0].samples) > 0
    assert {s[0] for e, s, _n in vm.first_uses if e == "batch"} == {8}
    odd = PiperVoice.from_config_path(cfg, seed=2, mesh=port_mesh(n=6))
    audios = odd.speak_batch(["tɛst wʌn.", "tuː.", "θɹiː.", "fɔːɹ.",
                              "faɪv."])
    assert len(audios) == 5 and all(len(a.samples) > 0 for a in audios)
    # bucket 8, rounded up to the data axis of 6, as the reference does
    assert {s[0] for e, s, _n in odd.first_uses if e == "batch"} == {12}
    vm.close()
    odd.close()


def test_lattice_enumerates_the_mesh_rounded_batches(cfg, monkeypatch):
    """A served mesh voice warms the batch shapes it dispatches: the
    lattice's batch axis and window ladder are rounded to the data axis,
    and a warmed window shape is met warm."""
    from sonata_tpu_torch.utils.dispatch_policy import DispatchPolicy

    monkeypatch.setenv("SONATA_BATCH_MODE", "iteration")
    policy = DispatchPolicy(backend="cpu", coalesce=True, source="test")
    vm = PiperVoice.from_config_path(cfg, seed=2, mesh=port_mesh(n=6),
                                     dispatch_policy=policy)
    shapes = vm.lattice_shapes("full")
    batch = {s[0] for s in shapes if s[0] != "wdec"}
    wdec = {s[2] for s in shapes if s[0] == "wdec"}
    assert batch and all(b % 6 == 0 for b in batch)
    assert wdec and all(b % 6 == 0 for b in wdec)
    width = min(s[1] for s in shapes if s[0] == "wdec")
    vm.warm_shape(("wdec", width, 1, False))
    assert ("window", (width, 6, False, True)) in vm.warmed_shapes
    vm.close()


# ---------------------------------------------------------------------------
# mesh voices against the JAX mesh voices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_wav_matches_the_reference_mesh(cfg, tmp_path, layout):
    seq, model = LAYOUTS[layout]
    jv = JaxVoice.from_config_path(
        cfg, mesh=jax_make_mesh(8, seq_parallel=seq, model_parallel=model))
    try:
        JaxSynthesizer(jv).synthesize_to_file(tmp_path / "jax.wav", TEXT)
    finally:
        jv.close()
    pv = PiperVoice.from_config_path(cfg, mesh=port_mesh(seq, model),
                                     sampler=reference_sampler(0))
    SpeechSynthesizer(pv).synthesize_to_file(tmp_path / "port.wav", TEXT)
    pv.close()
    want, _, _ = read_wave_file(tmp_path / "jax.wav")
    got, _, _ = read_wave_file(tmp_path / "port.wav")
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("layout", ["dp_sp", "dp_sp_tp"])
def test_mesh_stream_matches_the_reference_mesh(cfg, exact_jax_frame_bucket,
                                                layout):
    seq, model = LAYOUTS[layout]
    jv = JaxVoice.from_config_path(
        cfg, mesh=jax_make_mesh(8, seq_parallel=seq, model_parallel=model))
    try:
        want = list(jv.stream_synthesis(STREAM, 12, 2))
    finally:
        jv.close()
    pv = PiperVoice.from_config_path(cfg, mesh=port_mesh(seq, model),
                                     sampler=reference_sampler(0))
    got = list(pv.stream_synthesis(STREAM, 12, 2))
    pv.close()
    assert [len(c.samples) for c in got] == [len(c.samples) for c in want]
    assert len(got) > 2
    for g_, w_ in zip(got, want):
        step = max(float(np.abs(w_.samples.data).max()), 0.01) / 32767.0
        assert np.abs(g_.samples.data - w_.samples.data).max() <= step + 1e-7


# ---------------------------------------------------------------------------
# refusals and checkpoints
# ---------------------------------------------------------------------------

def test_int8_and_replica_pools_refuse_a_mesh(cfg, plain):
    with pytest.raises(OperationError, match="int8"):
        PiperVoice.from_config_path(cfg, mesh=port_mesh(),
                                    decode_quant="int8")
    vm = PiperVoice.from_config_path(cfg, mesh=port_mesh())
    with pytest.raises(OperationError, match="mutually exclusive"):
        vm.replica_for_device("cpu")
    vm.close()
    from sonata_tpu_torch.frontends.grpc_server import SonataGrpcService

    with pytest.raises(OperationError, match="mutually exclusive"):
        SonataGrpcService(replicas=2, mesh=port_mesh(), device="cpu")


def test_checkpoint_round_trip(plain, tmp_path):
    path = tmp_path / "ckpt"
    checkpoint.save(path, plain.model)
    back = checkpoint.restore(path, like=plain.model)
    assert back is not plain.model
    for (name, a), (_, b) in zip(plain.model.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name
    flat = checkpoint.restore(path)
    assert set(flat) == set(plain.model.state_dict())
    with pytest.raises(ValueError, match="exists"):
        checkpoint.save(path, plain.model)
    checkpoint.save(path, {"w": torch.ones(3)}, force=True)
    assert torch.equal(checkpoint.restore(path, like={"w": torch.zeros(3)})
                       ["w"], torch.ones(3))


def test_checkpoint_restore_missing_or_corrupt_path(tmp_path):
    with pytest.raises(FailedToLoadResource, match="not found"):
        checkpoint.restore(tmp_path / "nope")
    (tmp_path / "bad").mkdir()
    with pytest.raises(FailedToLoadResource, match="cannot restore"):
        checkpoint.restore(tmp_path / "bad")


# ---------------------------------------------------------------------------
# the server's mesh flags
# ---------------------------------------------------------------------------

def test_server_main_mesh_flags(monkeypatch):
    """--mesh-devices/--seq-parallel/--model-parallel build the mesh the
    service attaches to loaded voices, over the visible CUDA devices (8
    stand-in entries here); more devices than visible, --device beside a
    mesh, the split flags without a mesh and a pool beside a mesh are
    refused."""
    import sonata_tpu_torch.frontends.grpc_server as gs
    from sonata_tpu_torch.parallel import mesh as pmesh

    captured = {}

    def fake_create(port=None, *, mesh=None, **kw):
        captured["mesh"] = mesh

        class _S:
            def start(self):
                pass

            def wait_for_termination(self):
                raise KeyboardInterrupt  # exit main immediately

            def stop(self, grace=None):
                pass

        return _S(), 1

    monkeypatch.setattr(gs, "create_server", fake_create)
    monkeypatch.setattr(pmesh, "_visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    gs.main(["--mesh-devices", "8", "--seq-parallel", "2"])
    assert captured["mesh"].shape == {"data": 4, "seq": 2, "model": 1}
    gs.main(["--mesh-devices", "8", "--seq-parallel", "2",
             "--model-parallel", "2"])
    assert captured["mesh"].shape == {"data": 2, "seq": 2, "model": 2}
    for argv in (["--mesh-devices", "9"],
                 ["--mesh-devices", "2", "--device", "cpu"],
                 ["--seq-parallel", "2"],
                 ["--mesh-devices", "2", "--replicas", "2"]):
        with pytest.raises(SystemExit):
            gs.main(argv)
    monkeypatch.setattr(pmesh, "_visible_devices", lambda: [])
    with pytest.raises(SystemExit):
        gs.main(["--mesh-devices", "1"])


def test_concurrent_spmd_calls_from_many_threads_stay_exact():
    """Several threads share one mesh's lanes at once (a voice's stage
    coalescer and window decoder do): every ring still equals exact
    attention, and none deadlocks, with a switch interval short enough to
    interleave the lanes' exchanges."""
    import sys
    import threading

    mesh = port_mesh(8)
    rng = np.random.default_rng(3)
    cases = []
    for _ in range(6):
        q, k, v = (_t(rng.standard_normal((1, 2, 32, 8))) for _ in range(3))
        lengths = torch.tensor([int(rng.integers(9, 33))])
        valid = (torch.arange(32)[None, :] < lengths[:, None]).float()
        cases.append((q, k, v, lengths, _exact_attention(q, k, v, valid)))
    errors = []

    def worker(case):
        q, k, v, lengths, want = case
        for _ in range(3):
            got = ring_attention(q, k, v, lengths, mesh)
            if not torch.allclose(got, want, atol=2e-5):
                errors.append(float((got - want).abs().max()))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(c,)) for c in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors
