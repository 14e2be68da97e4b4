"""Streaming decoder and BER-harness tests."""

import os
import sys

import numpy as np
import pytest

from audio_modem_radio.assembly import AssemblyRegistry
from audio_modem_radio.framing import crc32, pack_frame
from audio_modem_radio.modem import modulate
from audio_modem_radio.streaming import StreamingDecoder


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _tx(data: bytes, name: str = "s.bin", mode: str = "QPSK", rate: int = 4800):
    framed = pack_frame(name, data, 0, 1, len(data), crc32(data))
    return np.asarray(modulate(mode, framed, rate), np.float32)


def test_streaming_decodes_mid_stream(workdir):
    data1 = b"first transmission " * 20
    data2 = b"second transmission " * 20
    wave1, wave2 = _tx(data1, "one.bin"), _tx(data2, "two.bin")
    gap = np.zeros(40_000, np.float32)
    stream = np.concatenate([gap, wave1, gap, wave2, gap])

    dec = StreamingDecoder("QPSK", 4800, window=1 << 18, registry=AssemblyRegistry())
    saved = []
    # Feed in uneven chunks like a mic callback would.
    for start in range(0, len(stream), 37_000):
        saved += dec.feed(stream[start : start + 37_000])
    saved += dec.flush()
    assert len(saved) == 2
    contents = sorted(open(p, "rb").read() for p in saved)
    assert contents == sorted([data1, data2])


def test_streaming_deduplicates_overlap(workdir):
    data = b"overlap me " * 30
    wave = _tx(data)
    # Place the transmission so it appears in two overlapping windows.
    stream = np.concatenate(
        [np.zeros(100_000, np.float32), wave, np.zeros(300_000, np.float32)]
    )
    dec = StreamingDecoder("QPSK", 4800, window=1 << 18, overlap=1 << 17,
                           registry=AssemblyRegistry())
    saved = dec.feed(stream) + dec.flush()
    assert len(saved) == 1  # decoded once despite overlapping windows


def test_streaming_resamples(workdir):
    from audio_modem_radio.utils.wavio import resample

    data = b"rate mismatch " * 20
    wave48 = resample(_tx(data), 96000, 48000)
    dec = StreamingDecoder("QPSK", 4800, window=1 << 18, sample_rate=48000,
                           registry=AssemblyRegistry())
    saved = dec.feed(wave48) + dec.flush()
    assert len(saved) == 1 and open(saved[0], "rb").read() == data


def test_ber_harness(workdir):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks"))
    try:
        from ber import measure_mode
    finally:
        sys.path.pop(0)

    clean = measure_mode("QPSK", snr_db=30.0, payload_len=512, trials=2)
    assert clean["ber"] == 0.0
    assert clean["frame_recovery_rate"] == 1.0

    hopeless = measure_mode("QPSK", snr_db=-25.0, payload_len=512, trials=1)
    assert hopeless["frame_recovery_rate"] == 0.0
