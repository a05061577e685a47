"""The router's fleet cache in the port (``serving/fleetcache.py``, a
scripted copy): the unit scenarios of the JAX package's
``tests/test_fleetcache.py`` re-pointed at the port (:mod:`torch_ported`),
and the router-derived key pinned to the golden digest of the JAX
package's cache, from both routers."""

from torch_ported import exec_ported

exec_ported("test_fleetcache.py", globals())

#: the cross-process cache key of ``tests/test_synthcache.py``
GOLDEN_KEY = "3f752ca4f09880b14864b068052d1410"


def _router_key(pkg):
    """The pinned request's key as a router of package ``pkg`` derives it
    from wire bytes (its voice info learned off a LoadVoice response)."""
    import importlib

    pbm = importlib.import_module(f"{pkg}.frontends.grpc_messages")
    fcm = importlib.import_module(f"{pkg}.serving.fleetcache")
    meshm = importlib.import_module(f"{pkg}.serving.mesh")
    router = meshm.MeshRouter([meshm.NodeSpec("127.0.0.1", 40000, 41000)],
                              start_probers=False)
    try:
        fc = fcm.FleetCache(router)
        info = pbm.VoiceInfo(
            voice_id="1234",
            synth_options=pbm.SynthesisOptions(
                speaker="bob", length_scale=1.0, noise_scale=0.667,
                noise_w=0.8),
            speakers={2: "bob"},
            audio=pbm.AudioInfo(sample_rate=16000, num_channels=1,
                                sample_width=2))
        fc.learn_voice(pbm.VoiceInfo.decode(info.encode()))
        req = pbm.Utterance(voice_id="1234",
                            text=" Pinned  KEY derivation. ",
                            speech_args=pbm.SpeechArgs(
                                rate=10, volume=50, pitch=50,
                                appended_silence_ms=0))
        return fc.routing_key("realtime", pbm.Utterance.decode(req.encode()))
    finally:
        router.close()


def test_router_key_is_the_golden_digest_in_both_packages():
    assert _router_key("sonata_tpu_torch") == GOLDEN_KEY
    assert _router_key("sonata_tpu") == GOLDEN_KEY
