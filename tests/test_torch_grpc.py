"""The port's gRPC server against the JAX package's, over real channels.

Both servers run in this process on ephemeral loopback ports and load the
same tiny voice from disk (``write_tiny_voice``, its noise scales set to
0 so the audio is deterministic); the port's server loads it with
``device="cpu"``.  ``SONATA_NODE_ID`` is pinned so both name the same
node.  Two pairs: both servers as ``create_server(0)`` builds them, and
both with ``--continuous-batching`` and a 2-replica pool (the slice's
serving path: the pool, the replicas' schedulers); speech args are
compared on each.

Tolerances: ``SynthesizeUtterance`` (lazy and batched) the same number of
results with equal lengths, samples within ±2 int16 LSB;
``SynthesizeUtteranceRealtime`` the same chunk boundaries, ±1 LSB; the
unary RPCs' messages byte-equal; the error cases the same status codes.
"""

import json

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from sonata_tpu.frontends import grpc_messages as jpb
from sonata_tpu.frontends.grpc_server import create_server as jax_server
from sonata_tpu_torch.frontends import grpc_messages as pb
from sonata_tpu_torch.frontends.grpc_server import create_server

from voices import write_tiny_voice

TEXT = "Hello there, from the server. A second sentence follows here."
STREAM_TEXT = ("This longer sentence streams through the realtime call in "
               "several chunks of audio.")


@pytest.fixture(autouse=True)
def exact_jax_frame_bucket(monkeypatch):
    """The port takes each group's exact frame bucket; the JAX voice
    estimates one and retries on overflow.  Its estimate pinned to the
    smallest bucket, every retry lands on the exact bucket, so a stream's
    last window sits where the port's does."""
    from sonata_tpu.models.piper import PiperVoice as JaxVoice
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])


def quiet_voice(dirpath, seed=3, **overrides):
    """A tiny voice on disk whose inference noise scales are 0."""
    cfg = write_tiny_voice(dirpath, seed=seed, **overrides)
    d = json.loads(cfg.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    cfg.write_text(json.dumps(d))
    return cfg


def _unary(channel, name, req, resp_cls):
    fn = channel.unary_unary(f"/sonata_grpc.sonata_grpc/{name}",
                             request_serializer=lambda m: m.encode(),
                             response_deserializer=resp_cls.decode)
    return fn(req)


def _stream(channel, name, req, resp_cls):
    fn = channel.unary_stream(f"/sonata_grpc.sonata_grpc/{name}",
                              request_serializer=lambda m: m.encode(),
                              response_deserializer=resp_cls.decode)
    return list(fn(req))


def _serve_pair(tmp_path_factory, name, **server_kwargs):
    mp = pytest.MonkeyPatch()
    mp.setenv("SONATA_NODE_ID", "node-a")
    cfg = str(quiet_voice(tmp_path_factory.mktemp(name)))
    servers = []
    try:
        j_server, j_port = jax_server(0, **server_kwargs)
        servers.append(j_server)
        p_server, p_port = create_server(0, device="cpu", **server_kwargs)
        servers.append(p_server)
        for s in servers:
            s.start()
        chans = (grpc.insecure_channel(f"127.0.0.1:{j_port}"),
                 grpc.insecure_channel(f"127.0.0.1:{p_port}"))
        vids = [_unary(c, "LoadVoice", pb.VoicePath(config_path=cfg),
                       pb.VoiceInfo).voice_id for c in chans]
        assert vids[0] == vids[1]
        yield {"jax": chans[0], "port": chans[1], "cfg": cfg,
               "vid": vids[0], "servers": servers}
    finally:
        for s in servers:
            s.stop(grace=None)
            s.sonata_service.shutdown()
        mp.undo()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both servers as ``create_server(0)`` builds them: batch synthesis
    on the handler path (the port's on its voice's batch thread)."""
    yield from _serve_pair(tmp_path_factory, "grpc_pair")


@pytest.fixture(scope="module")
def pool_pair(tmp_path_factory):
    """Both servers with ``--continuous-batching`` and a 2-replica pool: the
    JAX one on two of the forced host devices, the port's on the CPU twice.
    ``SynthesizeUtterance`` then runs the pool and the replicas'
    schedulers; the realtime RPC the loaded voice's stream engines."""
    yield from _serve_pair(tmp_path_factory, "grpc_pool_pair",
                           continuous_batching=True, replicas=2)


def _pcm(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype="<i2").astype(np.int32)


#: speech args the reference post-processes each result with
SPEECH_ARGS = dict(rate=30, volume=80, pitch=60, appended_silence_ms=120)


def _utterances_match(pair, mode, speech_args=None):
    req = pb.Utterance(voice_id=pair["vid"], text=TEXT,
                       synthesis_mode=getattr(pb.SynthesisMode, mode),
                       speech_args=(None if speech_args is None
                                    else pb.SpeechArgs(**speech_args)))
    want = _stream(pair["jax"], "SynthesizeUtterance", req,
                   jpb.SynthesisResult)
    got = _stream(pair["port"], "SynthesizeUtterance", req,
                  pb.SynthesisResult)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        a, b = _pcm(g.wav_samples), _pcm(w.wav_samples)
        assert a.size == b.size > 0
        assert np.abs(a - b).max() <= 2
        assert g.rtf > 0


def _realtime_matches(pair):
    req = pb.Utterance(voice_id=pair["vid"], text=STREAM_TEXT,
                       realtime_chunk_size=20, realtime_chunk_padding=3)
    want = _stream(pair["jax"], "SynthesizeUtteranceRealtime", req,
                   jpb.WaveSamples)
    got = _stream(pair["port"], "SynthesizeUtteranceRealtime", req,
                  pb.WaveSamples)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        a, b = _pcm(g.wav_samples), _pcm(w.wav_samples)
        assert a.size == b.size > 0
        assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("mode", ["LAZY", "BATCHED"])
def test_synthesize_utterance_matches_jax(pair, mode):
    _utterances_match(pair, mode)


def test_synthesize_realtime_matches_jax(pair):
    _realtime_matches(pair)


@pytest.mark.parametrize("mode", ["LAZY", "BATCHED"])
def test_speech_args_utterance_matches_jax(pair, mode):
    """Speech args post-process each result; the port synthesizes on its
    voice's batch thread, the reference on the handler thread."""
    _utterances_match(pair, mode, SPEECH_ARGS)


@pytest.mark.parametrize("mode", ["LAZY", "BATCHED"])
def test_pool_synthesize_utterance_matches_jax(pool_pair, mode):
    _utterances_match(pool_pair, mode)
    for srv in pool_pair["servers"]:
        (v,) = srv.sonata_service._voices.values()
        assert len(v.pool.replicas) == 2
        assert all(r.dispatches > 0 for r in v.pool.replicas)


@pytest.mark.parametrize("mode", ["LAZY", "BATCHED"])
def test_pool_speech_args_utterance_matches_jax(pool_pair, mode):
    """With speech args the port's sentences still ride the pool (the
    reference's ride its handler thread); the post-processed results
    agree all the same."""
    _utterances_match(pool_pair, mode, SPEECH_ARGS)


def test_pool_synthesize_realtime_matches_jax(pool_pair):
    _realtime_matches(pool_pair)


@pytest.mark.parametrize("name,req,resp", [
    ("GetVoiceInfo", "vid", "VoiceInfo"),
    ("GetSynthesisOptions", "vid", "SynthesisOptions"),
    ("ListVoices", "empty", "VoiceList"),
    ("CheckHealth", "empty", "HealthStatus"),
    ("GetSonataVersion", "empty", "Version"),
    ("LoadVoice", "path", "VoiceInfo"),
])
def test_unary_messages_equal(pair, name, req, resp):
    message = {"vid": pb.VoiceIdentifier(voice_id=pair["vid"]),
               "empty": pb.Empty(),
               "path": pb.VoicePath(config_path=pair["cfg"])}[req]
    want = _unary(pair["jax"], name, message, getattr(jpb, resp))
    got = _unary(pair["port"], name, message, getattr(pb, resp))
    assert got.encode() == want.encode()


def test_set_synthesis_options_equal(pair):
    for length_scale in (1.3, 1.0):
        req = pb.VoiceSynthesisOptions(
            voice_id=pair["vid"],
            synthesis_options=pb.SynthesisOptions(length_scale=length_scale,
                                                  noise_scale=0.0,
                                                  noise_w=0.0))
        want = _unary(pair["jax"], "SetSynthesisOptions", req,
                      jpb.SynthesisOptions)
        got = _unary(pair["port"], "SetSynthesisOptions", req,
                     pb.SynthesisOptions)
        assert got.encode() == want.encode()
        assert got.length_scale == pytest.approx(length_scale)


def _error_request(case, pair):
    vid = pair["vid"]
    return {
        "unknown-voice-info": ("GetVoiceInfo", "unary",
                               pb.VoiceIdentifier(voice_id="999")),
        "missing-config": ("LoadVoice", "unary",
                           pb.VoicePath(config_path="/nope/missing.json")),
        "empty-config": ("LoadVoice", "unary", pb.VoicePath()),
        "unload-unknown": ("UnloadVoice", "unary",
                           pb.VoiceIdentifier(voice_id="999")),
        "unknown-speaker": ("SetSynthesisOptions", "unary",
                            pb.VoiceSynthesisOptions(
                                voice_id=vid,
                                synthesis_options=pb.SynthesisOptions(
                                    speaker="nobody"))),
        "options-unknown-voice": ("GetSynthesisOptions", "unary",
                                  pb.VoiceIdentifier(voice_id="999")),
        "synthesize-unknown-voice": ("SynthesizeUtterance", "stream",
                                     pb.Utterance(voice_id="999",
                                                  text="Hello.")),
        "realtime-unknown-voice": ("SynthesizeUtteranceRealtime", "stream",
                                   pb.Utterance(voice_id="999",
                                                text="Hello.")),
    }[case]


@pytest.mark.parametrize("case", [
    "unknown-voice-info", "missing-config", "empty-config", "unload-unknown",
    "unknown-speaker", "options-unknown-voice", "synthesize-unknown-voice",
    "realtime-unknown-voice"])
def test_error_status_codes_match_jax(pair, case):
    name, kind, req = _error_request(case, pair)
    codes = []
    for side in ("jax", "port"):
        call = _unary if kind == "unary" else _stream
        with pytest.raises(grpc.RpcError) as e:
            call(pair[side], name, req, pb.Empty)
        codes.append(e.value.code())
    assert codes[0] == codes[1]
    assert codes[1] in (grpc.StatusCode.NOT_FOUND,
                        grpc.StatusCode.INVALID_ARGUMENT)


def test_mesh_devices_flag_is_refused(capsys):
    from sonata_tpu_torch.frontends import grpc_server

    with pytest.raises(SystemExit):
        grpc_server.main(["--mesh-devices", "2"])
    assert "multi-GPU" in capsys.readouterr().err
