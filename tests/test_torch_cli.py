"""The port's CLI against the JAX package's: the same arguments through
both ``main(argv)`` in this process (the port with ``--device cpu``), on
one tiny voice from disk whose noise scales are 0.

Tolerance: the WAVs (or raw stdout samples) of the same request the same
length, within ±2 int16 LSB; ``--info`` the same JSON; the same exit codes.
"""

import io
import json
import sys

import numpy as np
import pytest

from sonata_tpu.frontends import cli as jcli
from sonata_tpu_torch.audio import read_wave_file
from sonata_tpu_torch.frontends import cli

from voices import write_tiny_voice

TEXT = "The command line speaks. It writes a second sentence too."


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


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    path = write_tiny_voice(tmp_path_factory.mktemp("cli"), seed=5)
    d = json.loads(path.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    path.write_text(json.dumps(d))
    return str(path)


def _close(a, b, lsb=2):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a - b).max() <= lsb


@pytest.mark.parametrize("extra", [["--mode", "lazy"],
                                   ["--mode", "parallel"],
                                   ["--mode", "realtime", "--chunk-size",
                                    "20"],
                                   ["--length-scale", "1.3"]],
                         ids=["lazy", "parallel", "realtime", "scaled"])
def test_wav_matches_jax(cfg, tmp_path, extra):
    want_path, got_path = tmp_path / "jax.wav", tmp_path / "port.wav"
    assert jcli.main([cfg, TEXT, "-o", str(want_path), *extra]) == 0
    assert cli.main([cfg, TEXT, "-o", str(got_path), "--device", "cpu",
                     *extra]) == 0
    want, want_rate, _ = read_wave_file(want_path)
    got, got_rate, _ = read_wave_file(got_path)
    assert got_rate == want_rate == 16000
    _close(got, want)


def test_raw_stdout_matches_jax(cfg, capsysbinary):
    assert jcli.main([cfg, "Raw samples.", "-o", "-"]) == 0
    want = capsysbinary.readouterr().out
    assert cli.main([cfg, "Raw samples.", "-o", "-", "--device", "cpu"]) == 0
    got = capsysbinary.readouterr().out
    _close(np.frombuffer(got, "<i2"), np.frombuffer(want, "<i2"))


def test_stdin_json_loop_matches_jax(cfg, tmp_path, monkeypatch):
    lines = "\n".join(json.dumps(r) for r in (
        {"text": "First request."},
        {"text": "Second request, slower.", "length_scale": 1.2},
        {"no_text": 1})) + "\n"
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        out = tmp_path / f"{name}.wav"
        assert main([cfg, "-o", str(out), *extra]) == 0
        outs[name] = [read_wave_file(tmp_path / f"{name}-{i}.wav")[0]
                      for i in range(2)]
        assert not (tmp_path / f"{name}-2.wav").exists()
    for got, want in zip(outs["port"], outs["jax"]):
        _close(got, want)


def test_info_matches_jax(cfg, capsys):
    assert jcli.main([cfg, "--info"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([cfg, "--info"]) == 0
    assert json.loads(capsys.readouterr().out) == want


def test_errors_match_jax(tmp_path, capsys):
    missing = str(tmp_path / "missing.json")
    assert jcli.main([missing, "Hi.", "-o", str(tmp_path / "a.wav")]) == 1
    assert cli.main([missing, "Hi.", "-o", str(tmp_path / "b.wav"),
                     "--device", "cpu"]) == 1
    capsys.readouterr()


def test_port_cli_defaults_to_the_card(cfg, tmp_path):
    """Without ``--device`` the voice loads on the GPU: on a host without
    one that is a typed error (exit 1), never a CPU fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main([cfg, "Hi.", "-o", str(tmp_path / "x.wav")]) == 1
    assert not (tmp_path / "x.wav").exists()
    parser = cli.build_parser()
    assert parser.parse_args([cfg]).device is None
    assert parser.prog == "sonata-tpu-torch"
