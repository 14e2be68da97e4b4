"""Coherent-tracked DSSS receive (z² Viterbi&Viterbi on the despread stream).

DSSS ends in differential DBPSK on the despread 16-chip coherent sums
(ops/dsss.py), so it pays the DBPSK noisy-reference penalty at its
below-noise-floor waterfall. Round 5 applies ops/psk.bpsk_tracked_bits to
the despread bit phasors (ops/dsss._dsss_bytes_tracked); measured recovery
(benchmarks/dsss_bound.py, 10 trials/cell): differential 0.20 @ −14 dB
full-band SNR vs tracked 0.70 — roughly +1 dB on the envelope mode.

Reference anchor: the reference's "DSSS" is an unspread DBPSK alias
(/root/reference/modem.py:380-383); the bar is our own bound harness.
"""

import numpy as np

from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import demodulate, modulate
from audio_modem_radio.ops import dsss

BAUD, CARRIER, SR = 4800, 3000.0, 96000


def _frame(n=300, seed=3):
    payload = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    return payload, pack_frame("d.bin", payload, 0, 1, n, crc32(payload))


def _noisy(wave, snr_db, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(wave**2) / 10 ** (snr_db / 10.0))
    return (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)


def test_tracked_clean_roundtrip():
    payload, framed = _frame()
    wave = np.asarray(dsss.dsss_real_modulate(framed, BAUD, CARRIER, SR), np.float32)
    frames = parse_frames(dsss.dsss_tracked_demodulate(wave, BAUD, CARRIER, SR))
    assert frames and frames[0].data == payload


def test_tracked_below_noise_floor():
    """The tracked receiver must hold the mode's headline capability:
    bit-exact recovery at −9 dB full-band SNR (the differential path's
    operating point — both receivers are solid here)."""
    payload, framed = _frame()
    wave = np.asarray(dsss.dsss_real_modulate(framed, BAUD, CARRIER, SR), np.float32)
    noisy = _noisy(wave, -9.0, seed=400)
    frames = parse_frames(dsss.dsss_tracked_demodulate(noisy, BAUD, CARRIER, SR))
    assert frames and frames[0].data == payload


def test_tracked_beats_differential_deep():
    """At −13 dB full-band SNR (measured waterfall tail: differential 0.40
    recovery, tracked 0.50; seeds 402/403/409 are diff-fail/tracked-win
    points) the tracked receiver recovers a capture differential detection
    cannot."""
    payload, framed = _frame()
    wave = np.asarray(dsss.dsss_real_modulate(framed, BAUD, CARRIER, SR), np.float32)
    noisy = _noisy(wave, -13.0, seed=402)
    assert not parse_frames(dsss.dsss_real_demodulate(noisy, BAUD, CARRIER, SR))
    frames = parse_frames(dsss.dsss_tracked_demodulate(noisy, BAUD, CARRIER, SR))
    assert frames and frames[0].data == payload


def test_mode_level_escalation():
    """modem's DSSS receive escalates to the despread-stream tracker when
    differential detection finds no complete capture — and only when the
    shared psk_coherent_escalation flag allows."""
    from audio_modem_radio.config import CONFIG

    payload, framed = _frame()
    wave = np.asarray(modulate("DSSS", framed, BAUD), np.float32)
    noisy = _noisy(wave, -13.0, seed=402)
    frames = parse_frames(demodulate("DSSS", noisy, BAUD))
    assert frames and frames[0].data == payload

    CONFIG.set("modem.psk_coherent_escalation", False)
    try:
        assert not parse_frames(demodulate("DSSS", noisy, BAUD))
    finally:
        CONFIG.set("modem.psk_coherent_escalation", True)
