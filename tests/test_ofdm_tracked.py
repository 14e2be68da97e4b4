"""Coherent-tracked OFDM receive (per-subcarrier Viterbi&Viterbi z⁴ track).

OFDM here is per-subcarrier differential DQPSK across time (ops/ofdm.py), so
each subcarrier pays the same ~2.3 dB noisy-reference penalty the
single-carrier PSK family stopped paying in round 4. Round 5 applies
ops/psk._tracked_phase per subcarrier (ops/ofdm._ofdm_tracked_dibits);
measured waterfalls (6 seeds/cell, CPU JAX):

  OFDM4: differential 3/6 @ 8 dB, 0/6 below; tracked 6/6 @ 7 dB, 4/6 @ 6 dB
  OFDM8: differential 1/6 @ 8 dB; tracked 6/6 @ 7 dB, 2/6 @ 6 dB

i.e. ≥2 dB at both waterfalls. These tests pin the clean path, the penalty
window, and the mode-level escalation wiring.

Reference anchor: the reference's OFDM modes are single-carrier DQPSK
aliases with no multicarrier receiver at all (/root/reference/modem.py:
371-376), so the bar is our own bound harness (benchmarks/ofdm_bound.py),
not reference parity.
"""

import numpy as np

from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import demodulate, modulate
from audio_modem_radio.ops import ofdm

BAUD, CARRIER, SR = 9600, 12000.0, 96000


def _frame(n=800, seed=3):
    payload = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    return payload, pack_frame("o.bin", payload, 0, 1, n, crc32(payload))


def _noisy(wave, snr_db, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(wave**2) / 10 ** (snr_db / 10.0))
    return (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)


def test_tracked_clean_roundtrip_k4_k8():
    payload, framed = _frame()
    for k in (4, 8):
        wave = np.asarray(ofdm.ofdm_modulate(framed, BAUD, CARRIER, k), np.float32)
        frames = parse_frames(ofdm.ofdm_tracked_demodulate(wave, BAUD, CARRIER, k))
        assert frames and frames[0].data == payload, f"K={k}"


def test_tracked_clean_with_silence_and_noise():
    payload, framed = _frame()
    wave = np.asarray(ofdm.ofdm_modulate(framed, BAUD, CARRIER, 4), np.float32)
    cap = np.concatenate(
        [np.zeros(5000, np.float32), wave, np.zeros(2000, np.float32)]
    )
    cap = _noisy(cap, 25.0, seed=11)
    frames = parse_frames(ofdm.ofdm_tracked_demodulate(cap, BAUD, CARRIER, 4))
    assert frames and frames[0].data == payload


def test_tracked_beats_differential_k4():
    """At 7 dB full-band SNR the OFDM4 differential receiver recovers
    nothing (measured 0/6 seeds) while the tracked receiver is solid
    (6/6) — inside the measured ~2 dB per-subcarrier penalty window."""
    payload, framed = _frame()
    wave = np.asarray(ofdm.ofdm_modulate(framed, BAUD, CARRIER, 4), np.float32)
    noisy = _noisy(wave, 7.0, seed=100)
    assert not parse_frames(ofdm.ofdm_demodulate(noisy, BAUD, CARRIER, 4))
    frames = parse_frames(ofdm.ofdm_tracked_demodulate(noisy, BAUD, CARRIER, 4))
    assert frames and frames[0].data == payload


def test_tracked_beats_differential_k8():
    payload, framed = _frame()
    wave = np.asarray(ofdm.ofdm_modulate(framed, BAUD, CARRIER, 8), np.float32)
    noisy = _noisy(wave, 7.0, seed=100)
    assert not parse_frames(ofdm.ofdm_demodulate(noisy, BAUD, CARRIER, 8))
    frames = parse_frames(ofdm.ofdm_tracked_demodulate(noisy, BAUD, CARRIER, 8))
    assert frames and frames[0].data == payload


def test_mode_level_escalation():
    """modem's OFDM4 receive escalates to the per-subcarrier tracker when
    the differential pass finds no complete capture — and only when the
    shared psk_coherent_escalation flag allows."""
    from audio_modem_radio.config import CONFIG

    payload, framed = _frame()
    wave = np.asarray(modulate("OFDM4", framed, BAUD), np.float32)
    noisy = _noisy(wave, 7.0, seed=200)
    frames = parse_frames(demodulate("OFDM4", noisy, BAUD))
    assert frames and frames[0].data == payload

    CONFIG.set("modem.psk_coherent_escalation", False)
    try:
        assert not parse_frames(demodulate("OFDM4", noisy, BAUD))
    finally:
        CONFIG.set("modem.psk_coherent_escalation", True)
