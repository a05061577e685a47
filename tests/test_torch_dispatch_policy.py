"""The port's dispatch policy against the JAX package's.

``resolve_policy`` of both packages gets the same environments and the same
probe results (stubbed), and must give the same knobs; the port's backend
is the voice device's type, so a stubbed ``"cuda"`` backend stands for a
voice on the card.  Then the probe on the CPU, and the policy reaching the
voice's engines and the batch scheduler.
"""

import pytest

from sonata_tpu.utils import dispatch_policy as jax_policy
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.synth import BatchScheduler
from sonata_tpu_torch.utils import buckets, dispatch_policy as policy
from sonata_tpu_torch.utils.dispatch_policy import (
    COALESCING_DEFAULTS,
    DispatchPolicy,
    ProbeResult,
    probe_dispatch_scaling,
    resolve_policy,
)

from voices import write_tiny_voice

KNOBS = ("coalesce", "stream_decode_max_batch", "stream_decode_max_wait_ms",
         "stream_stage_max_batch", "stream_stage_max_wait_ms",
         "scheduler_max_batch", "scheduler_max_wait_ms")

#: (t1_ms, tn_ms) probe results: a card (flat scaling), a serial backend,
#: a tunnelled one (40 ms a dispatch)
PROBES = {"flat": (1.0, 1.3), "serial": (1.0, 7.6), "tunnel": (41.0, 48.0)}


def _probe(t1, tn, calls=None):
    def fn(shape_key, backend=None, device=None):
        if calls is not None:
            calls.append(backend)
        return ProbeResult(backend=backend, n=8, t1_ms=t1, tn_ms=tn)
    return fn


def _jax_probe(t1, tn):
    def fn(shape_key, backend=None):
        return jax_policy.ProbeResult(backend=backend, n=8, t1_ms=t1,
                                      tn_ms=tn)
    return fn


@pytest.mark.parametrize("env", [
    {}, {"SONATA_DISPATCH_POLICY": "on"}, {"SONATA_DISPATCH_POLICY": "off"},
    {"SONATA_DISPATCH_POLICY": "banana"},
    {"SONATA_STREAM_COALESCE": "0", "SONATA_DISPATCH_POLICY": "on"},
    {"SONATA_STREAM_COALESCE": "1", "SONATA_DISPATCH_POLICY": "off"},
])
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_knobs_match_the_reference(env, backend, probe):
    t1, tn = PROBES[probe]
    got = resolve_policy(backend=backend, env=env, probe_fn=_probe(t1, tn))
    # the JAX package's accelerator backend is its "tpu"
    want = jax_policy.resolve_policy(
        backend="tpu" if backend == "cuda" else "cpu", env=env,
        probe_fn=_jax_probe(t1, tn))
    assert {k: getattr(got, k) for k in KNOBS} == \
        {k: getattr(want, k) for k in KNOBS}


def test_cpu_fast_path_never_probes():
    calls = []
    p = resolve_policy(backend="cpu", env={}, probe_fn=_probe(1, 1, calls))
    assert p.coalesce is False and not calls
    assert p.stream_decode_kwargs() == {"max_batch": 1, "max_wait_ms": 0.0}
    assert p.stream_stage_kwargs() == {"max_batch": 1, "max_wait_ms": 0.0}
    assert p.scheduler_kwargs() == {"max_batch": 1, "max_wait_ms": 0.0}


def test_stubbed_cuda_backend_takes_the_coalescing_defaults():
    calls = []
    p = resolve_policy(backend="cuda", env={},
                       probe_fn=_probe(1.0, 1.3, calls))
    assert calls == ["cuda"] and p.coalesce is True
    assert p.stream_decode_kwargs() == {
        "max_batch": COALESCING_DEFAULTS["stream_decode_max_batch"],
        "max_wait_ms": COALESCING_DEFAULTS["stream_decode_max_wait_ms"]}
    assert p.stream_stage_kwargs() == {"max_batch": 8, "max_wait_ms": 8.0}
    assert p.scheduler_kwargs() == {"max_batch": 16, "max_wait_ms": 5.0}
    assert COALESCING_DEFAULTS == jax_policy.COALESCING_DEFAULTS

    def broken(shape_key, backend=None, device=None):
        raise RuntimeError("device wedged")

    assert resolve_policy(backend="cuda", env={}, probe_fn=broken).coalesce


def test_backend_is_the_voice_devices_type(monkeypatch):
    assert policy._default_backend("cpu") == "cpu"
    seen = []
    monkeypatch.setattr(policy, "_default_backend",
                        lambda device=None: seen.append(device) or "cuda")
    p = resolve_policy(device="cuda:1", env={}, probe_fn=_probe(1.0, 1.3))
    assert seen == ["cuda:1"] and p.backend == "cuda" and p.coalesce


def test_canonical_dispatch_batch_matches_the_reference():
    from sonata_tpu.utils.buckets import canonical_dispatch_batch

    for n in (0, 1, 3, 8, 9, 16, 40):
        assert buckets.canonical_dispatch_batch(n) == \
            canonical_dispatch_batch(n)


def test_probe_runs_on_the_device_once_and_is_cached():
    policy._clear_probe_cache()
    try:
        r1 = probe_dispatch_scaling((32, 256), reps=1, device="cpu")
        assert probe_dispatch_scaling((32, 256), reps=1, device="cpu") is r1
        assert probe_dispatch_scaling((64, 256), reps=1,
                                      device="cpu") is not r1
        assert r1.backend == "cpu" and r1.t1_ms > 0 and r1.tn_ms > 0
        assert r1.per_dispatch_ms >= 0 and r1.per_item_ms >= 0
    finally:
        policy._clear_probe_cache()


@pytest.fixture(scope="module")
def voice_path(tmp_path_factory):
    return write_tiny_voice(tmp_path_factory.mktemp("policy"), seed=9)


def test_voice_resolves_once_and_streams_per_request_on_cpu(voice_path,
                                                           monkeypatch):
    monkeypatch.delenv("SONATA_DISPATCH_POLICY", raising=False)
    monkeypatch.delenv("SONATA_STREAM_COALESCE", raising=False)
    monkeypatch.delenv("SONATA_BATCH_MODE", raising=False)
    v = PiperVoice.from_config_path(voice_path, device="cpu")
    try:
        p1 = v.dispatch_policy
        monkeypatch.setenv("SONATA_DISPATCH_POLICY", "on")
        assert v.dispatch_policy is p1 and p1.coalesce is False
        assert list(v.stream_synthesis("həlˈoʊ wˈɜːld", 20, 3))
        stats = v.dispatch_stats()
        assert stats["batch_mode"] == "dispatch"
        assert stats["policy"]["backend"] == "cpu"
        for stage in ("stream_decode", "stream_stage"):
            assert stats[stage]["coalescing_ratio"] == 1.0
        assert stats["iteration"] is None
        assert v._stream_coalescer._max_batch == 1
        assert v._stage_coalescer._max_batch == 1
    finally:
        v.close()


def test_env_and_injected_policies_reach_the_engines(voice_path,
                                                     monkeypatch):
    monkeypatch.setenv("SONATA_DISPATCH_POLICY", "on")
    monkeypatch.delenv("SONATA_BATCH_MODE", raising=False)
    v = PiperVoice.from_config_path(voice_path, device="cpu")
    try:
        assert v.dispatch_policy.coalesce is True
        assert v._stream_decoder._max_batch == 8  # the iteration loop
        assert v._stream_stages._max_batch == 8
        assert v.dispatch_stats()["batch_mode"] == "iteration"
    finally:
        v.close()
    monkeypatch.setenv("SONATA_DISPATCH_POLICY", "off")
    pol = DispatchPolicy(backend="test", coalesce=True, source="injected",
                         stream_decode_max_batch=4,
                         stream_decode_max_wait_ms=1.0)
    monkeypatch.setenv("SONATA_BATCH_MODE", "dispatch")
    v = PiperVoice.from_config_path(voice_path, device="cpu",
                                    dispatch_policy=pol)
    try:
        assert v.dispatch_policy is pol
        assert v._stream_decoder._max_batch == 4
    finally:
        v.close()


def test_batch_scheduler_defaults_from_the_voice_policy(voice_path):
    v = PiperVoice.from_config_path(voice_path, device="cpu")
    s = BatchScheduler(v)
    try:
        assert s._max_batch == 1 and s._max_wait == 0.0  # CPU pass-through
    finally:
        s.shutdown()
    s = BatchScheduler(v, max_batch=8, max_wait_ms=200.0)
    try:
        assert s._max_batch == 8 and abs(s._max_wait - 0.2) < 1e-9
    finally:
        s.shutdown()
        v.close()
