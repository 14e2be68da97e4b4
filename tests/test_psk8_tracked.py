"""Coherent-tracked D8PSK receive (Viterbi&Viterbi 8th-power carrier track).

The measured sensitivity decomposition (benchmarks/psk8_bound.py, PERF.md)
attributes the full ~2.35 dB gap between the production differential receiver
and the coherent bound to differential DETECTION — a noisy one-symbol phase
reference. The wire format is differential only in its encoding, so the
tracked receiver (windowed z⁸ phase reference, absolute sector decisions,
differential decode) recovers that penalty. These tests pin:

* bit-exactness of the tracked path on clean captures,
* the low-SNR window where tracking decodes and differential detection fails,
* CFO-ramp immunity of the tracker's frequency pre-correction,
* the mode-level escalation wiring (modem._psk8_mode_demodulate).

Reference anchor: the reference's 8PSK is a DQPSK alias with no receiver of
its own (/root/reference/modem.py:345-348), so the bar here is our own
bound harness, not reference parity.
"""

import numpy as np
import pytest

from audio_modem_radio.config import CONFIG
from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import demodulate
from audio_modem_radio.ops import psk

BAUD, CARRIER, SR = 4800, 12000.0, 96000


def _frame(n=512, seed=3):
    payload = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    return payload, pack_frame("t8.bin", payload, 0, 1, n, crc32(payload))


def _noisy(wave, snr_db, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(wave**2) / 10 ** (snr_db / 10.0))
    return (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)


def test_tracked_clean_roundtrip():
    payload, framed = _frame()
    wave = psk.psk8_real_modulate(framed, BAUD, CARRIER, SR)
    out = psk.psk8_tracked_demodulate(wave, BAUD, CARRIER, SR)
    frames = parse_frames(out)
    assert frames and frames[0].data == payload


def test_tracked_clean_with_silence_and_noise():
    payload, framed = _frame()
    wave = np.asarray(psk.psk8_real_modulate(framed, BAUD, CARRIER, SR), np.float32)
    cap = np.concatenate(
        [np.zeros(5000, np.float32), wave, np.zeros(2000, np.float32)]
    )
    cap = _noisy(cap, 25.0, seed=11)
    frames = parse_frames(psk.psk8_tracked_demodulate(cap, BAUD, CARRIER, SR))
    assert frames and frames[0].data == payload


def test_tracked_beats_differential_detection():
    """In the measured 2.35 dB window (between the differential-detection
    waterfall and the coherent bound) tracking must decode a frame the
    differential receiver cannot."""
    payload, framed = _frame()
    wave = psk.psk8_real_modulate(framed, BAUD, CARRIER, SR)
    noisy = _noisy(wave, 7.5, seed=21)
    assert not parse_frames(psk.psk8_real_demodulate(noisy, BAUD, CARRIER, SR))
    frames = parse_frames(psk.psk8_tracked_demodulate(noisy, BAUD, CARRIER, SR))
    assert frames and frames[0].data == payload


def test_mode_level_escalation():
    """modem's 8PSK receive escalates to the tracker when differential
    detection yields no CRC-valid frame — and only when the flag allows."""
    payload, framed = _frame()
    wave = psk.psk8_real_modulate(framed, BAUD, CARRIER, SR)
    noisy = _noisy(wave, 7.5, seed=21)
    frames = parse_frames(demodulate("8PSK", noisy, BAUD))
    assert frames and frames[0].data == payload

    CONFIG.set("modem.psk_coherent_escalation", False)
    try:
        assert not parse_frames(demodulate("8PSK", noisy, BAUD))
    finally:
        CONFIG.set("modem.psk_coherent_escalation", True)


def test_tracked_survives_cfo_ramp():
    """A 50 Hz carrier offset (~1% of baud) defeats a naive windowed average
    (the ×8 phase turns 4.2 rad per 64-symbol window); the tracker's ramp
    pre-correction must absorb it."""
    payload, framed = _frame(n=256)
    wave = psk.psk8_real_modulate(framed, BAUD, CARRIER + 50.0, SR)
    out = psk.psk8_tracked_demodulate(
        _noisy(wave, 30.0, seed=5), BAUD, CARRIER, SR
    )
    frames = parse_frames(out)
    assert frames and frames[0].data == payload


def test_qpsk_tracked_e2e_beats_differential():
    """DQPSK at 2.2 dB full-band SNR (4800 Bd): differential detection has
    ~1e-3 BER (frame-exact recovery essentially impossible) while the
    tracked receiver sits on the coherent bound (~6e-5) — and the mode-level
    QPSK decode must recover the frame through the escalation."""
    payload, framed = _frame()
    wave = np.asarray(psk.qpsk_modulate(framed, BAUD, 3000.0, SR))
    noisy = _noisy(wave, 2.2, seed=23)
    assert not parse_frames(psk.qpsk_demodulate(noisy, BAUD, 3000.0, SR))
    frames = parse_frames(psk.qpsk_tracked_demodulate(noisy, BAUD, 3000.0, SR))
    assert frames and frames[0].data == payload
    frames = parse_frames(demodulate("QPSK", noisy, BAUD))
    assert frames and frames[0].data == payload


def test_qpsk_tracked_ber_improvement():
    """Stream-level: the tracked dibit stream must carry an order of
    magnitude fewer errors than differential detection in the penalty
    window (measured ~10x at 1.5-3 dB, PERF.md)."""
    import jax.numpy as jnp

    _, framed = _frame(n=2048, seed=5)
    wave = np.asarray(psk.qpsk_modulate(framed, BAUD, 3000.0, SR))
    d_re, d_im, _ = psk.psk_demod_streams(
        jnp.asarray(wave, jnp.float32), BAUD, 3000.0, SR
    )
    hi_t, lo_t = (np.asarray(a) for a in psk.qpsk_gray_streams(d_re, d_im))
    n = len(wave) // (SR // BAUD) - 1

    noisy = _noisy(wave, 2.0, seed=31)
    dr, di, _ = psk.psk_demod_streams(jnp.asarray(noisy), BAUD, 3000.0, SR)
    h, l = (np.asarray(a) for a in psk.qpsk_gray_streams(dr, di))
    e_diff = int(np.sum(h[:n] != hi_t[:n])) + int(np.sum(l[:n] != lo_t[:n]))
    rf, imf, _ = psk.psk_symbol_streams(jnp.asarray(noisy), BAUD, 3000.0, SR, n_psk=4)
    hv, lv = (np.asarray(a) for a in psk.qpsk_tracked_gray_streams(rf, imf))
    e_vv = int(np.sum(hv[:n] != hi_t[:n])) + int(np.sum(lv[:n] != lo_t[:n]))
    assert e_diff >= 10, f"SNR point drifted: diff errors {e_diff}"
    assert e_vv * 4 < e_diff, f"tracked {e_vv} vs diff {e_diff}"


def test_bpsk_tracked_ber_improvement():
    """DBPSK's z² tracker: fewer stream errors than differential detection
    in the noisy-reference penalty window.

    Operating point: -4 dB full-band SNR (spsym=20 → Eb/N0 ≈ 6 dB), where
    the differential stream carries ~130 errors in 16k bits and the tracker
    roughly halves them (measured e_diff 128/136, e_vv 76/72 on seeds
    31/47). 0 dB full-band (Eb/N0 ≈ 10 dB) produced ZERO differential
    errors with the round-4 receiver, so the guard below tripped — the
    fixture must sit where differential detection actually errs."""
    import jax.numpy as jnp

    _, framed = _frame(n=2048, seed=5)
    wave = np.asarray(psk.bpsk_modulate(framed, BAUD, 3000.0, SR))
    d_re, d_im, _ = psk.psk_demod_streams(
        jnp.asarray(wave, jnp.float32), BAUD, 3000.0, SR
    )
    bits_t = np.asarray(d_re < 0).astype(np.uint8)
    n = len(wave) // (SR // BAUD) - 1

    noisy = _noisy(wave, -4.0, seed=31)
    dr, _, _ = psk.psk_demod_streams(jnp.asarray(noisy), BAUD, 3000.0, SR)
    e_diff = int(np.sum(np.asarray(dr < 0).astype(np.uint8)[:n] != bits_t[:n]))
    rf, imf, _ = psk.psk_symbol_streams(jnp.asarray(noisy), BAUD, 3000.0, SR, n_psk=4)
    bv = np.asarray(psk.bpsk_tracked_bits(rf, imf))
    e_vv = int(np.sum(bv[:n] != bits_t[:n]))
    assert e_diff >= 30, f"SNR point drifted: diff errors {e_diff}"
    assert e_vv < e_diff, f"tracked {e_vv} vs diff {e_diff}"


def test_tracked_matches_differential_sectors_clean():
    """On a clean capture the tracked delta-sector stream must agree with
    differential detection everywhere (both are error-free)."""
    _, framed = _frame(n=128)
    wave = psk.psk8_real_modulate(framed, BAUD, CARRIER, SR)
    import jax.numpy as jnp

    d_re, d_im, _ = psk.psk_demod_streams(
        jnp.asarray(wave, jnp.float32), BAUD, CARRIER, SR, n_psk=8
    )
    sec_dd = np.asarray(psk.psk8_sector_stream(d_re, d_im))
    re_f, im_f, _ = psk.psk_symbol_streams(
        jnp.asarray(wave, jnp.float32), BAUD, CARRIER, SR, n_psk=8
    )
    sec_vv = np.asarray(psk.psk8_tracked_sectors(re_f, im_f))
    n_sym = len(wave) // (SR // BAUD)
    np.testing.assert_array_equal(sec_vv[: n_sym - 1], sec_dd[: n_sym - 1])


def test_escalation_rescues_partial_multiframe_capture():
    """Round-5 escalation policy (ADVICE r4 low #4): a multi-frame capture
    where differential detection decodes part 0 but loses part 1 inside the
    ~2.3 dB noisy-reference penalty window must still get the tracked pass —
    the old policy returned raw on ANY CRC-valid frame, stranding the lost
    frames. Operating point: part 1 at 3 dB full-band SNR (measured: diff
    parses 1 valid + 1 damaged; tracked parses both on 5/6 seeds — seed 20
    chosen). The 3200-sample gap is 160 symbols = 320 bits = 40 bytes, so
    frame 1 stays byte-aligned after the single global magic alignment."""
    from audio_modem_radio.framing import pack_frame, parse_frames_detailed
    from audio_modem_radio.modem import modulate

    def _part(n, part, seed):
        payload = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
        payload = payload.tobytes()
        return payload, pack_frame("two.bin", payload, part, 2, 2 * n, 0)

    p1, f1 = _part(600, 0, 10)
    p2, f2 = _part(600, 1, 11)
    w1 = np.asarray(modulate("QPSK", f1, BAUD), np.float32)
    w2 = np.asarray(modulate("QPSK", f2, BAUD), np.float32)
    rng = np.random.default_rng(20)
    sigma = np.sqrt(np.mean(w2**2) / 10 ** (3.0 / 10.0))
    w2n = (w2 + rng.normal(0.0, sigma, len(w2))).astype(np.float32)
    cap = np.concatenate([w1, np.zeros(3200, np.float32), w2n])

    CONFIG.set("modem.psk_coherent_escalation", False)
    try:
        v_off, d_off = parse_frames_detailed(demodulate("QPSK", cap, BAUD))
    finally:
        CONFIG.set("modem.psk_coherent_escalation", True)
    assert len(v_off) == 1 and d_off, "operating point drifted: want 1 valid + damage"

    v_on, _ = parse_frames_detailed(demodulate("QPSK", cap, BAUD))
    assert len(v_on) == 2
    assert sorted(f.part_number for f in v_on) == [0, 1]
    assert {f.data for f in v_on} == {p1, p2}
