"""The port's C ABI against the JAX package's, both driven through ctypes
in this process.

The port's library (``sonata_tpu_torch/native/src/sonata_capi.cpp``, a
copy of the JAX package's with its bridge module re-pointed) is built
with ``g++`` against this interpreter's headers, without ``libpython``,
and joins the running interpreter; ``SONATA_DEVICE=cpu`` makes its bridge
load voices on the CPU.  Both libraries load the same tiny voice from
disk, its noise scales 0.

Tolerance: the same SPEECH/FINISHED/ERROR event sequence, each SPEECH
event's samples the same length within ±2 int16 LSB; the same audio info,
synth config and return codes; the written WAVs within ±2 LSB.
"""

import ctypes
import json
import sysconfig

import numpy as np
import pytest

from sonata_tpu.native.build import load_capi_library as load_jax_capi
from sonata_tpu_torch.audio import read_wave_file
from sonata_tpu_torch.native import build as tbuild

from voices import write_tiny_voice


class Event(ctypes.Structure):
    _fields_ = [("event_type", ctypes.c_int32), ("error", ctypes.c_char_p),
                ("len", ctypes.c_uint64),
                ("data", ctypes.POINTER(ctypes.c_int16))]


CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.POINTER(Event),
                            ctypes.c_void_p)


class Params(ctypes.Structure):
    _fields_ = [("mode", ctypes.c_int32), ("rate", ctypes.c_uint8),
                ("volume", ctypes.c_uint8), ("pitch", ctypes.c_uint8),
                ("appended_silence_ms", ctypes.c_uint32),
                ("callback", CALLBACK), ("user_data", ctypes.c_void_p),
                ("nonblocking", ctypes.c_int32)]


class AudioInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_uint32),
                ("num_channels", ctypes.c_uint32),
                ("sample_width", ctypes.c_uint32)]


class SynthConfig(ctypes.Structure):
    _fields_ = [("length_scale", ctypes.c_float),
                ("noise_scale", ctypes.c_float),
                ("noise_w", ctypes.c_float), ("speaker_id", ctypes.c_int64)]


def _bind(lib):
    lib.libsonataLoadVoiceFromConfigPath.restype = ctypes.c_int64
    lib.libsonataLoadVoiceFromConfigPath.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.libsonataUnloadSonataVoice.argtypes = [ctypes.c_int64]
    lib.libsonataGetAudioInfo.argtypes = [ctypes.c_int64,
                                          ctypes.POINTER(AudioInfo)]
    lib.libsonataGetPiperDefaultSynthConfig.argtypes = [
        ctypes.c_int64, ctypes.POINTER(SynthConfig)]
    lib.libsonataSpeak.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.POINTER(Params)]
    lib.libsonataSpeakToFile.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                         ctypes.c_char_p,
                                         ctypes.POINTER(Params)]
    lib.libsonataGetVersion.restype = ctypes.c_char_p
    return lib


@pytest.fixture(autouse=True)
def exact_jax_frame_bucket(monkeypatch):
    """The port takes each group's exact frame bucket; the JAX voice's
    estimate pinned to the smallest bucket makes its overflow retry land
    on the same one, so a stream's last window sits where the port's
    does."""
    from sonata_tpu.models.piper import PiperVoice as JaxVoice
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SONATA_DEVICE", "cpu")
    cfg = write_tiny_voice(tmp_path_factory.mktemp("capi"), seed=12)
    d = json.loads(cfg.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    cfg.write_text(json.dumps(d))
    jlib, tlib = load_jax_capi(), tbuild.load_capi_library()
    assert jlib is not None and tlib is not None
    pair = {"jax": _bind(jlib), "port": _bind(tlib)}
    handles = {}
    for side, lib in pair.items():
        err = ctypes.c_char_p()
        handles[side] = lib.libsonataLoadVoiceFromConfigPath(
            str(cfg).encode(), ctypes.byref(err))
        assert handles[side] > 0, err.value
    yield pair, handles
    for side, lib in pair.items():
        assert lib.libsonataUnloadSonataVoice(handles[side]) == 0
    mp.undo()


def test_port_library_is_its_own_build():
    path = tbuild.build(tbuild.CAPI_SRC, lib_name=tbuild.CAPI_LIB_NAME,
                        prefix="capi",
                        flags=(f"-I{sysconfig.get_path('include')}",),
                        deps=(tbuild.CAPI_HEADER,))
    assert path.is_file() and "sonata_tpu_torch" in str(path)
    src = tbuild.CAPI_SRC.read_text()
    assert '"sonata_tpu_torch.frontends.capi_bridge"' in src


def _events(lib, handle, text, mode):
    events = []

    def on_event(ev_ptr, user):
        ev = ev_ptr.contents
        if ev.event_type == 0:
            events.append(("speech", np.ctypeslib.as_array(
                ev.data, shape=(ev.len,)).astype(np.int32)))
        elif ev.event_type == 1:
            events.append(("finished", None))
        else:
            events.append(("error", None))
        return 0

    p = Params(mode=mode, rate=255, volume=255, pitch=255,
               appended_silence_ms=0, callback=CALLBACK(on_event),
               user_data=None, nonblocking=0)
    rc = lib.libsonataSpeak(handle, text.encode(), ctypes.byref(p))
    return rc, events


@pytest.mark.parametrize("mode,text", [
    (0, "Hello from native code. Second sentence."),
    (1, "Batched sentences. Two of them."),
    (2, "A longer sentence that the realtime mode cuts into chunks of "
        "audio, one event each."),
], ids=["lazy", "batched", "realtime"])
def test_event_sequence_matches_jax(libs, mode, text):
    pair, handles = libs
    out = {side: _events(lib, handles[side], text, mode)
           for side, lib in pair.items()}
    (jrc, jev), (trc, tev) = out["jax"], out["port"]
    assert trc == jrc == 0
    assert [k for k, _ in tev] == [k for k, _ in jev]
    assert tev[-1][0] == "finished" and len(tev) >= 3
    for (_, a), (_, b) in zip(tev[:-1], jev[:-1]):
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a - b).max() <= 2


def test_errors_match_jax(libs):
    pair, _handles = libs
    rcs = {side: _events(lib, 987654, "No such voice.", 0)
           for side, lib in pair.items()}
    assert rcs["port"][0] == rcs["jax"][0] != 0
    assert [k for k, _ in rcs["port"][1]] == [k for k, _ in rcs["jax"][1]] \
        == ["error"]
    for side, lib in pair.items():
        err = ctypes.c_char_p()
        assert lib.libsonataLoadVoiceFromConfigPath(
            b"/nope.json", ctypes.byref(err)) < 0
        assert b"nope" in err.value
        assert lib.libsonataUnloadSonataVoice(987654) != 0


def test_info_config_version_and_file_match(libs, tmp_path):
    pair, handles = libs
    got = {}
    for side, lib in pair.items():
        info, cfg = AudioInfo(), SynthConfig()
        assert lib.libsonataGetAudioInfo(handles[side],
                                         ctypes.byref(info)) == 0
        assert lib.libsonataGetPiperDefaultSynthConfig(
            handles[side], ctypes.byref(cfg)) == 0
        wav = tmp_path / f"{side}.wav"
        assert lib.libsonataSpeakToFile(handles[side], b"To a file.",
                                        str(wav).encode(), None) == 0
        got[side] = ((info.sample_rate, info.num_channels,
                      info.sample_width),
                     (cfg.length_scale, cfg.noise_scale, cfg.noise_w,
                      cfg.speaker_id),
                     lib.libsonataGetVersion(),
                     read_wave_file(wav)[0].astype(np.int32))
    j, t = got["jax"], got["port"]
    assert t[:3] == j[:3]
    assert t[3].shape == j[3].shape and np.abs(t[3] - j[3]).max() <= 2
