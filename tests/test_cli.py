"""CLI surface tests (encode-file / decode-wav / modes / stats / recommend)."""

import json

import pytest

from audio_modem_radio.cli import main


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_encode_decode_via_cli(workdir, capsys):
    src = workdir / "hello.bin"
    src.write_bytes(b"cli round trip payload " * 50)

    rc = main(["encode-file", str(src), "--mode", "QPSK", "--symbol-rate", "4800"])
    out = capsys.readouterr().out
    assert rc == 0
    wav = [l for l in out.splitlines() if l.endswith(".wav")][0]

    rc = main(["decode-wav", wav, "--mode", "QPSK", "--symbol-rate", "4800"])
    out = capsys.readouterr().out
    assert rc == 0
    saved = [l for l in out.splitlines() if "recv_" in l][0]
    assert open(saved, "rb").read() == src.read_bytes()


def test_decode_failure_exit_code(workdir, capsys, rng):
    import numpy as np

    from audio_modem_radio.utils.wavio import write_wav

    noise = rng.normal(0, 0.2, 48000).astype(np.float32)
    write_wav(str(workdir / "noise.wav"), noise)
    rc = main(["decode-wav", str(workdir / "noise.wav")])
    capsys.readouterr()
    assert rc == 1


def test_modes_listing(capsys):
    assert main(["modes"]) == 0
    out = capsys.readouterr().out
    for mode in ("QPSK", "FSK1200", "HELLSCHREIBER", "PSK31", "OFDM8"):
        assert mode in out


def test_stats_json(workdir, capsys):
    src = workdir / "f.bin"
    src.write_bytes(b"x" * 10_000)
    assert main(["stats", str(src), "--mode", "QPSK", "--symbol-rate", "9600"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["bytes_per_sec"] == 2400


def test_recommend(capsys):
    assert main(["recommend", "--priority", "speed"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert "recommended" in rec and "mode" in rec["recommended"]
