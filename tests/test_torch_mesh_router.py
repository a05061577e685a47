"""The port's ``sonata-mesh`` router tier.

- The unit scenarios of the JAX package's ``tests/test_mesh.py``,
  re-pointed at the port (:mod:`torch_ported`): the router
  (``serving/mesh.py``) and its gRPC front (``frontends/mesh_server.py``)
  are scripted copies.
- Integration over real loopback channels: the port's router in front of
  two of the port's servers on ``device="cpu"``, held against a direct
  call to a backend (identical) and against the JAX router in front of a
  JAX server on the same tiny voice (its noise scales 0):
  ``SynthesizeUtterance`` within ±2 int16 LSB, the realtime RPC with the
  same chunk boundaries within ±1 LSB.  Both routers run their fleet
  cache, whose key must equal the backends' own.
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from torch_ported import exec_ported

exec_ported("test_mesh.py", globals())

grpc = pytest.importorskip("grpc")

from sonata_tpu.frontends import grpc_messages as jpb  # noqa: E402
from sonata_tpu.frontends.grpc_server import (  # noqa: E402
    create_server as jax_server,
)
from sonata_tpu.frontends.mesh_server import (  # noqa: E402
    create_mesh_server as jax_mesh_server,
)
from sonata_tpu.serving.mesh import (  # noqa: E402
    MeshRouter as JaxRouter,
    parse_backends as jax_parse_backends,
)
from sonata_tpu_torch.frontends import grpc_messages as tpb  # noqa: E402
from sonata_tpu_torch.frontends.grpc_server import (  # noqa: E402
    create_server as port_server,
)
from sonata_tpu_torch.frontends.mesh_server import (  # noqa: E402
    create_mesh_server as port_mesh_server,
)
from sonata_tpu_torch.serving.mesh import (  # noqa: E402
    MeshRouter as PortRouter,
    parse_backends as port_parse_backends,
)

from voices import write_tiny_voice  # noqa: E402

ROUTER_TEXT = "The router carries this sentence. And a second one."
ROUTER_STREAM = ("This longer sentence streams through the router in "
                 "several chunks of audio.")
FLEET_ENV = {"SONATA_SYNTH_CACHE_MB": "8", "SONATA_FLEETCACHE": "1"}


@pytest.fixture
def pinned_jax_frame_bucket(monkeypatch):
    """The JAX voice's frame estimate pinned to the smallest bucket, so its
    retry lands on the exact bucket the port's stream takes."""
    from sonata_tpu.models.piper import PiperVoice as JaxVoice
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])


def _quiet_voice(dirpath):
    cfg = write_tiny_voice(dirpath, seed=7)
    d = json.loads(cfg.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    cfg.write_text(json.dumps(d))
    return str(cfg)


def _cluster(cfg, n_backends, make_server, make_router, parse, make_mesh,
             pb, **server_kw):
    backends = []
    for _ in range(n_backends):
        server, port = make_server(0, continuous_batching=True,
                                   metrics_port=0, request_timeout_s=60.0,
                                   **server_kw)
        server.start()
        server.sonata_service.warmup_and_mark_ready()
        backends.append((server, port))
    specs = ",".join(f"127.0.0.1:{port}/{s.sonata_runtime.http_port}"
                     for s, port in backends)
    router = make_router(parse(specs), probe_interval_s=0.2,
                         name="test-router")
    mesh_server, mesh_port = make_mesh(0, router=router, metrics_port=0,
                                       request_timeout_s=60.0)
    mesh_server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{mesh_port}")
    info = channel.unary_unary(
        "/sonata_grpc.sonata_grpc/LoadVoice",
        request_serializer=lambda m: m.encode(),
        response_deserializer=pb.VoiceInfo.decode)(
            pb.VoicePath(config_path=cfg))
    return {"channel": channel, "voice_id": info.voice_id, "pb": pb,
            "backends": backends, "mesh_server": mesh_server,
            "router": router}


def _close(cluster):
    cluster["channel"].close()
    cluster["mesh_server"].stop(grace=None)
    cluster["mesh_server"].sonata_service.shutdown()
    for server, _port in cluster["backends"]:
        server.stop(grace=None)
        server.sonata_service.shutdown()


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """The port's router over two port servers, the JAX router over one
    JAX server, both with the fleet cache on; one voice for all."""
    saved = {k: os.environ.get(k) for k in FLEET_ENV}
    os.environ.update(FLEET_ENV)
    cfg = _quiet_voice(tmp_path_factory.mktemp("router_voice"))
    clusters = []
    try:
        clusters.append(_cluster(cfg, 2, port_server, PortRouter,
                                 port_parse_backends, port_mesh_server, tpb,
                                 device="cpu"))
        clusters.append(_cluster(cfg, 1, jax_server, JaxRouter,
                                 jax_parse_backends, jax_mesh_server, jpb))
        assert clusters[0]["voice_id"] == clusters[1]["voice_id"]
        yield {"port": clusters[0], "jax": clusters[1]}
    finally:
        for c in clusters:
            _close(c)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _call(channel, name, req, resp_cls, rid=None):
    fn = channel.unary_stream(f"/sonata_grpc.sonata_grpc/{name}",
                              request_serializer=lambda m: m.encode(),
                              response_deserializer=resp_cls.decode)
    return fn(req, metadata=(("x-request-id", rid),) if rid else None,
              timeout=60.0)


def _pcm(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype="<i2").astype(np.int32)


def _direct_channel(cluster, node_id):
    port = int(node_id.rsplit(":", 1)[1])
    return grpc.insecure_channel(f"127.0.0.1:{port}")


@pytest.mark.parametrize("rpc,text,tol", [
    ("SynthesizeUtterance", ROUTER_TEXT, 2),
    ("SynthesizeUtteranceRealtime", ROUTER_STREAM, 1),
])
def test_router_audio_matches_direct_call_and_reference_router(
        routers, pinned_jax_frame_bucket, rpc, text, tol):
    out = {}
    for pkg in ("port", "jax"):
        c = routers[pkg]
        pb = c["pb"]
        resp = (pb.SynthesisResult if rpc == "SynthesizeUtterance"
                else pb.WaveSamples)
        call = _call(c["channel"], rpc,
                     pb.Utterance(voice_id=c["voice_id"], text=text), resp,
                     rid=f"{pkg}-{rpc}")
        results = list(call)
        trailers = dict(call.trailing_metadata() or ())
        out[pkg] = [_pcm(r.wav_samples) for r in results]
        node = trailers.get("x-sonata-node-id")
        assert node in {f"127.0.0.1:{p}" for _s, p in c["backends"]}
        if pkg == "port":  # the router's audio is the backend's
            ch = _direct_channel(c, node)
            try:
                direct = [_pcm(r.wav_samples) for r in _call(
                    ch, rpc, pb.Utterance(voice_id=c["voice_id"], text=text),
                    resp)]
            finally:
                ch.close()
            assert len(direct) == len(out[pkg]) > 0
            for a, b in zip(out[pkg], direct):
                np.testing.assert_array_equal(a, b)
    got, want = out["port"], out["jax"]
    assert [g.size for g in got] == [w.size for w in want]
    assert len(got) > 1  # two sentences; a stream of several chunks
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol


def test_router_metrics_count_routed_requests(routers):
    c = routers["port"]
    list(_call(c["channel"], "SynthesizeUtterance",
               c["pb"].Utterance(voice_id=c["voice_id"], text="Counted."),
               c["pb"].SynthesisResult))
    port = c["mesh_server"].sonata_runtime.http_port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        body = resp.read().decode()
    routed = [line for line in body.splitlines()
              if line.startswith("sonata_mesh_routed_total")]
    assert routed and float(routed[0].split()[-1]) >= 1


@pytest.mark.parametrize("kind", ["utterance", "realtime"])
def test_router_cache_key_equals_the_backends_and_the_reference(routers,
                                                                  kind):
    keys = {}
    for pkg in ("port", "jax"):
        c = routers[pkg]
        pb = c["pb"]
        request = pb.Utterance.decode(pb.Utterance(
            voice_id=c["voice_id"], text=" Affinity  KEY. ").encode())
        router_key = c["mesh_server"].sonata_service.fleetcache.routing_key(
            kind, request)
        for server, _port in c["backends"]:
            service = server.sonata_service
            voice = service._voices[c["voice_id"]]
            assert service._cache_key_for(voice, request, kind) == router_key
        keys[pkg] = router_key
    assert keys["port"] == keys["jax"] is not None
