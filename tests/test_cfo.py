"""Carrier-frequency-offset tolerance of the PSK receivers.

A CFO on this wire format (per-symbol carrier restart) is exactly a constant
rotation of every differential phasor; the receiver absorbs it with blind
4th-power derotation plus a quarter-turn sync retry (ops/psk.py). These tests
shift narrowband captures spectrally (analytic-signal mix — physical for
configs whose band stays positive) and assert bit-exact decode.
"""

import numpy as np
import pytest
from scipy.signal import hilbert

from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.ops.psk import (
    bpsk_demodulate,
    bpsk_modulate,
    estimate_cfo,
    qpsk_demodulate,
    qpsk_modulate,
)


def _framed(payload: bytes) -> bytes:
    return pack_frame("c.bin", payload, 0, 1, len(payload), crc32(payload))


def _shift(w: np.ndarray, df: float, fs: int = 96000) -> np.ndarray:
    z = hilbert(np.asarray(w, np.float64))
    return np.real(z * np.exp(2j * np.pi * df * np.arange(len(w)) / fs)).astype(np.float32)


@pytest.mark.parametrize("df", [0.0, 60.0, 120.0, 240.0, 480.0])
def test_qpsk_cfo_tolerance(df, rng):
    """QPSK 2400 Bd @ 6 kHz decodes bit-exact out to an 8% carrier offset."""
    payload = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    wave = qpsk_modulate(_framed(payload), 2400, 6000.0)
    frames = parse_frames(qpsk_demodulate(_shift(wave, df), 2400, 6000.0))
    assert frames and frames[0].data == payload


@pytest.mark.parametrize("df", [0.0, 60.0, 240.0])
def test_bpsk_cfo_tolerance(df, rng):
    payload = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    wave = bpsk_modulate(_framed(payload), 1200, 3000.0)
    frames = parse_frames(bpsk_demodulate(_shift(wave, df), 1200, 3000.0))
    assert frames and frames[0].data == payload


@pytest.mark.parametrize("df", [0.0, 30.0, 120.0])
def test_cfo_estimate_accuracy(df, rng):
    """estimate_cfo recovers the injected offset within 1 Hz (mod baud/4)."""
    payload = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    wave = qpsk_modulate(_framed(payload), 2400, 6000.0)
    est = estimate_cfo(_shift(wave, df), 2400.0, 6000.0, 96000)
    wrapped = (df + 300) % 600 - 300  # estimator resolves mod baud/4
    assert abs(est - wrapped) < 1.0


def test_cfo_batch_path(rng):
    """The batched fast path decodes frequency-shifted captures too."""
    from audio_modem_radio.parallel.batch import decode_sample_batch
    from audio_modem_radio.parallel.mesh import get_mesh

    # Registry QPSK uses carrier 3000 Hz; keep shifts narrowband there.
    shifts = [0.0, 30.0, 60.0, 120.0]
    payloads, waves = [], []
    for i, df in enumerate(shifts):
        p = bytes(f"cfo capture {i} ".encode() * 20)
        payloads.append(p)
        w = qpsk_modulate(
            pack_frame(f"f{i}.bin", p, 0, 1, len(p), crc32(p)), 2400, 3000.0
        )
        waves.append(_shift(w, df))
    n = max(len(w) for w in waves)
    batch = np.zeros((len(waves), n), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    raws = decode_sample_batch(batch, "QPSK", 2400, mesh=get_mesh())
    for raw, p in zip(raws, payloads):
        frames = parse_frames(raw)
        assert frames and frames[0].data == p
