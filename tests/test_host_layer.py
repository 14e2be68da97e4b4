"""Host-layer tests: PTT, audio I/O fakes, observability, console app."""

import json
import logging
import os
import time

import numpy as np
import pytest

from audio_modem_radio.observability import (
    AnalyticsStore,
    LogManager,
    PerformanceMonitor,
    setup_logging,
)
from audio_modem_radio.ptt import PTTContext, PTTManager, SimulatedPort


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


# --- PTT ------------------------------------------------------------------

def test_ptt_noop_without_port():
    mgr = PTTManager(pre_tx_delay=0)
    mgr.connect(None)
    mgr.ptt_on()  # must not raise
    assert not mgr.is_keyed
    mgr.ptt_off()


def test_ptt_simulated_key_sequence():
    mgr = PTTManager(pre_tx_delay=0)
    mgr.connect("SIM", "RTS")
    mgr.ptt_on()
    assert mgr.is_keyed and mgr.ser.rts and not mgr.ser.dtr
    sim = mgr.ser
    mgr.ptt_off()
    assert not mgr.is_keyed and not sim.is_open
    # DTR method
    mgr.connect("SIM", "DTR")
    mgr.ptt_on()
    assert mgr.ser.dtr and not mgr.ser.rts
    mgr.ptt_off()


def test_ptt_context_keys_and_unkeys_even_on_error():
    mgr = PTTManager(pre_tx_delay=0)
    with pytest.raises(RuntimeError):
        with PTTContext("SIM", "RTS", controller=mgr):
            assert mgr.is_keyed
            raise RuntimeError("boom")
    assert not mgr.is_keyed


# --- audio I/O fakes ---------------------------------------------------------

def test_file_recorder_roundtrip(workdir):
    from audio_modem_radio.audio_io import FileRecorder, ReceiveSession
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.encoder import encode_file

    content = b"live capture simulation " * 30
    src = workdir / "x.bin"
    src.write_bytes(content)
    wav = encode_file(str(src), mode="QPSK", symbol_rate=4800)

    session = ReceiveSession(
        "QPSK", 4800, recorder=FileRecorder(wav), registry=AssemblyRegistry()
    )
    saved = session.run(seconds=10_000)  # longer than the capture: use it all
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == content


def test_recorder_unavailable_raises():
    from audio_modem_radio import audio_io

    if audio_io.SOUNDDEVICE_AVAILABLE:
        pytest.skip("sounddevice installed")
    with pytest.raises(RuntimeError):
        audio_io.Recorder().start()


# --- observability -------------------------------------------------------------

def test_setup_logging_and_rotation(workdir):
    log = setup_logging(log_file="t.log", console=False)
    log.info("hello world")
    for h in log.handlers:
        h.flush()
    assert "hello world" in open("t.log").read()

    lm = LogManager("t.log", max_bytes=10)
    rotated = lm.rotate()
    assert rotated and os.path.exists(rotated) and not os.path.exists("t.log")
    # cleanup handlers so later tests can chdir away
    for h in log.handlers:
        h.close()
    log.handlers.clear()


def test_performance_monitor_sample():
    info = PerformanceMonitor().sample()
    assert "timestamp" in info
    assert "cpu_percent" in info  # psutil is available in this image


def test_analytics_store_roundtrip(workdir):
    store = AnalyticsStore("a.json")
    store.record_encode("QPSK", 1000)
    store.record_decode("QPSK", 900)
    store.record_decode("FSK1200", 0, ok=False)
    store.record_metric("demod_msps", 4700.0)
    store.save()

    loaded = json.load(open("a.json"))
    assert loaded["files_sent"] == 1
    assert loaded["bytes_received"] == 900
    assert loaded["decode_errors"] == 1
    assert loaded["modes_used"]["QPSK"] == 2
    assert loaded["performance_metrics"]["demod_msps"] == 4700.0

    # persistence across instances
    store2 = AnalyticsStore("a.json")
    assert store2.data["files_sent"] == 1


# --- console app ----------------------------------------------------------------

def test_console_app_smoke(workdir, monkeypatch, capsys):
    from audio_modem_radio.app import ConsoleApp

    src = workdir / "tiny.bin"
    src.write_bytes(b"console app payload " * 10)

    inputs = iter(
        [
            "encode", str(src), "QPSK", "4800", "n",
            "config", "get modem.sample_rate",
            "analysis", "",
            "log",
            "quit",
        ]
    )
    monkeypatch.setattr("builtins.input", lambda *_: next(inputs))
    ConsoleApp(analytics=AnalyticsStore("app_analytics.json")).run()
    out = capsys.readouterr().out
    assert "wrote" in out and ".wav" in out
    assert "96000" in out
    assert "reception stats" in out

    # decode the WAV it produced, through the app too
    wav = [l.split("wrote ", 1)[1] for l in out.splitlines() if l.startswith("wrote ")][0]
    inputs = iter(["decode", wav, "QPSK", "4800", "quit"])
    monkeypatch.setattr("builtins.input", lambda *_: next(inputs))
    ConsoleApp(analytics=AnalyticsStore("app_analytics.json")).run()
    out = capsys.readouterr().out
    assert "1 file(s) recovered" in out


def test_spectral_gate_denoise(tmp_path, monkeypatch, rng):
    """The reference's dead noise_reduction flag has a real implementation:
    the spectral gate suppresses out-of-band structured interference without
    breaking a clean decode."""
    monkeypatch.chdir(tmp_path)
    from audio_modem_radio.decoder import decode_from_buffer
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.encoder import encode_file
    from audio_modem_radio.utils.denoise import spectral_gate
    from audio_modem_radio.utils.wavio import read_wav

    data = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    src = tmp_path / "d.bin"
    src.write_bytes(data)
    wav = encode_file(str(src), mode="FSK1200", symbol_rate=1200)
    samples, sr = read_wav(wav)

    # Clean decode with denoise on must still work.
    saved = decode_from_buffer(samples, "FSK1200", 1200, registry=AssemblyRegistry(),
                               sample_rate=sr, denoise=True, recv_dir=str(tmp_path / "a"))
    assert saved and open(saved[0], "rb").read() == data

    # Structured interference: a strong out-of-band hum is attenuated.
    t = np.arange(len(samples)) / 96000
    hum = (0.5 * np.sin(2 * np.pi * 17000 * t)).astype(np.float32)
    noisy = samples + hum
    gated = spectral_gate(noisy)
    # The bin-median gate keeps persistent narrowband bands (signal AND the
    # hum) and attenuates broadband hiss; what matters is that the signal
    # band passes at unity and the decode survives the preprocessing.
    saved = decode_from_buffer(noisy, "FSK1200", 1200, registry=AssemblyRegistry(),
                               sample_rate=sr, denoise=True, recv_dir=str(tmp_path / "b"))
    assert saved and open(saved[0], "rb").read() == data
    assert len(gated) == len(noisy) and gated.dtype == np.float32
