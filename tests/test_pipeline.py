"""End-to-end encoder/decoder pipeline tests (file -> WAV -> file)."""

import os

import numpy as np
import pytest

from audio_modem_radio.assembly import AssemblyRegistry
from audio_modem_radio.decoder import (
    decode_from_buffer,
    decode_wav_file,
    decode_with_retry,
    get_assembly_status,
    get_reception_stats,
)
from audio_modem_radio.encoder import (
    calculate_transmission_stats,
    encode_file,
    encode_file_parts,
    encode_file_paths,
    split_file_for_transmission,
    verify_audio_output,
)
from audio_modem_radio.utils.wavio import read_wav


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _write_file(workdir, name: str, data: bytes) -> str:
    p = workdir / name
    p.write_bytes(data)
    return str(p)


CONTENT = (b"End to end pipeline payload. " * 40)[:1000]


@pytest.mark.parametrize("mode,rate", [("QPSK", 9600), ("BPSK", 4800), ("FSK1200", 1200)])
def test_encode_decode_roundtrip(workdir, mode, rate):
    src = _write_file(workdir, "doc.bin", CONTENT)
    wav = encode_file(src, mode=mode, symbol_rate=rate)
    assert os.path.exists(wav)
    reg = AssemblyRegistry()
    saved = decode_wav_file(wav, mode, rate, registry=reg)
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == CONTENT


def test_encode_without_compression(workdir):
    src = _write_file(workdir, "doc.bin", CONTENT)
    wav = encode_file(src, mode="QPSK", compress=False, symbol_rate=9600)
    saved = decode_wav_file(wav, "QPSK", 9600, registry=AssemblyRegistry())
    assert open(saved[0], "rb").read() == CONTENT


def test_multipart_split_and_reassembly(workdir):
    # Force a split: FSK1200 moves 100 B/s; 1-minute parts hold ~5.4 KB.
    data = np.random.default_rng(7).integers(0, 256, 15000, dtype=np.uint8).tobytes()
    src = _write_file(workdir, "big.bin", data)
    parts = split_file_for_transmission(src, "FSK1200", 1200, target_duration_sec=60)
    assert len(parts) == 3
    assert parts[0][0] == "big.bin.part1" and parts[0][3] == 3

    wavs = encode_file_parts(parts, "FSK1200", True, 1200)
    assert len(wavs) == 3

    reg = AssemblyRegistry()
    # Decode parts out of order; file completes only on the last one.
    saved = []
    for w in (wavs[1], wavs[2], wavs[0]):
        samples, sr = read_wav(w)
        saved += decode_from_buffer(samples, "FSK1200", 1200, registry=reg, sample_rate=sr)
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == data
    assert get_assembly_status(reg) == []  # registry drained


def test_encode_file_auto_splits(workdir):
    data = np.random.default_rng(8).integers(0, 256, 15000, dtype=np.uint8).tobytes()
    src = _write_file(workdir, "auto.bin", data)
    wavs = encode_file_paths(src, mode="FSK1200", symbol_rate=1200, target_duration_min=1)
    assert len(wavs) == 3
    reg = AssemblyRegistry()
    saved = []
    for w in wavs:
        saved += decode_wav_file(w, "FSK1200", 1200, registry=reg)
    assert len(saved) == 1 and open(saved[0], "rb").read() == data


def test_decode_with_retry_handles_rate_mismatch(workdir):
    src = _write_file(workdir, "doc.bin", CONTENT)
    wav = encode_file(src, mode="QPSK", symbol_rate=2400)
    samples, _ = read_wav(wav)
    # decode at a 5%-off nominal rate: first attempt fails, sweep recovers
    saved = decode_with_retry(samples, "QPSK", int(2400 / 0.95), registry=AssemblyRegistry())
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == CONTENT


def test_decode_noise_returns_nothing(workdir):
    noise = np.random.default_rng(0).normal(0, 0.2, 48000).astype(np.float32)
    assert decode_from_buffer(noise, "QPSK", 9600, registry=AssemblyRegistry()) == []


def test_reception_stats_update(workdir):
    src = _write_file(workdir, "doc.bin", CONTENT)
    wav = encode_file(src, mode="QPSK", symbol_rate=9600)
    reg = AssemblyRegistry()
    decode_wav_file(wav, "QPSK", 9600, registry=reg)
    stats = get_reception_stats(reg)
    assert stats["total_files"] == 1
    assert stats["total_bytes"] == len(CONTENT)
    assert stats["success_rate"] == 100.0


def test_transmission_stats_model():
    stats = calculate_transmission_stats(100_000, "QPSK", 9600, compress=True)
    assert stats["bytes_per_sec"] == 2400
    assert stats["effective_size"] == 40_000
    assert stats["duration_sec"] == pytest.approx(40_000 / 2400)
    # fixed-rate modes
    assert calculate_transmission_stats(1000, "FSK1200", 9600)["bytes_per_sec"] == 100
    assert calculate_transmission_stats(1000, "HELLSCHREIBER", 9600)["compression_ratio"] == 1.0


def test_verify_audio_output_checklist():
    good = 0.5 * np.sin(np.linspace(0, 2000, 96000)).astype(np.float32)
    assert verify_audio_output(good)
    assert not verify_audio_output(None)
    assert not verify_audio_output(np.zeros(96000, np.float32))
    assert not verify_audio_output(np.full(96000, np.nan, np.float32))
    assert not verify_audio_output(good * 10)  # out of range
    assert not verify_audio_output(good[:100])  # too short


def test_cancellation(workdir):
    from audio_modem_radio.encoder import cancel_encoding, reset_encoding_cancel

    data = np.random.default_rng(9).integers(0, 256, 15000, dtype=np.uint8).tobytes()
    src = _write_file(workdir, "c.bin", data)
    parts = split_file_for_transmission(src, "FSK1200", 1200, 60)
    cancel_encoding()
    try:
        with pytest.raises(RuntimeError):
            encode_file_parts(parts, "FSK1200", True, 1200)
    finally:
        reset_encoding_cancel()


def test_progress_callback(workdir):
    calls = []
    src = _write_file(workdir, "doc.bin", CONTENT)
    encode_file_paths(src, mode="QPSK", symbol_rate=9600, progress_callback=lambda a, b: calls.append((a, b)))
    assert calls == [(1, 1)]


def test_decode_with_retry_batched_clock_drift(workdir):
    """A ±5% TX clock drift (baud AND carrier scaled) is recovered by the
    batched hypothesis sweep, and attempt dumps are written (reference
    decoder.py:353 parity)."""
    src = _write_file(workdir, "doc.bin", CONTENT)
    wav = encode_file(src, mode="QPSK", symbol_rate=4800)
    samples, _ = read_wav(wav)
    for d in (1.05, 0.95):
        drifted = np.interp(
            np.arange(int(len(samples) / d)) * d,
            np.arange(len(samples), dtype=float),
            samples.astype(np.float64),
        ).astype(np.float32)
        reg = AssemblyRegistry()
        saved = decode_with_retry(drifted, "QPSK", 4800, registry=reg)
        assert len(saved) == 1 and open(saved[0], "rb").read() == CONTENT
    import os
    dumps = [f for f in os.listdir("recv") if f.startswith("demodulated_attempt_")]
    assert len(dumps) >= 1
