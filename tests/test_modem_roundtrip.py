"""Loop-back tests: decode(modulate(frame(bytes))) must be bit-exact.

This is the spine of the test strategy (SURVEY.md §4): the reference had no
tests, only a manual encode->decode loop the author ran by hand (and whose one
logged QPSK attempt failed). Every physical mode is exercised on clean audio
and under impairments (AWGN, amplitude scaling, time offset, polarity flip).
"""

import numpy as np
import pytest

from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import MODES, demodulate, modulate
from audio_modem_radio.ops.fsk import fsk_demodulate, fsk_modulate
from audio_modem_radio.ops.psk import (
    bpsk_demodulate,
    bpsk_modulate,
    qpsk_demodulate,
    qpsk_modulate,
)

PAYLOAD = bytes(
    b"The quick brown fox jumps over the lazy dog. 0123456789 " * 8
)  # ~456 bytes


def _frame(data: bytes = PAYLOAD, name: str = "t.bin") -> bytes:
    return pack_frame(name, data, 0, 1, len(data), crc32(data))


def _assert_decodes(raw: bytes, data: bytes = PAYLOAD):
    frames = parse_frames(raw)
    assert frames, "no FBPC frame recovered from demodulated bytes"
    assert frames[0].data == data


# --- clean-audio round trips over the physical layer -------------------------

@pytest.mark.parametrize("baud", [1200, 4800, 9600])
def test_bpsk_roundtrip(baud):
    framed = _frame()
    wave = bpsk_modulate(framed, baud=baud)
    _assert_decodes(bpsk_demodulate(wave, baud=baud))


@pytest.mark.parametrize("baud", [1200, 4800, 9600])
def test_qpsk_roundtrip(baud):
    framed = _frame()
    wave = qpsk_modulate(framed, baud=baud)
    _assert_decodes(qpsk_demodulate(wave, baud=baud))


@pytest.mark.parametrize(
    "baud,mark,space",
    [(1200, 1200.0, 2200.0), (9600, 1200.0, 2200.0), (19200, 8000.0, 16000.0)],
)
def test_fsk_roundtrip(baud, mark, space):
    framed = _frame()
    wave = fsk_modulate(framed, baud=baud, mark_freq=mark, space_freq=space)
    _assert_decodes(fsk_demodulate(wave, baud=baud, mark_freq=mark, space_freq=space))


# --- impairments --------------------------------------------------------------

def test_qpsk_survives_awgn(rng):
    framed = _frame()
    wave = qpsk_modulate(framed, baud=2400)
    noisy = wave + rng.normal(0, 0.05, len(wave)).astype(np.float32)  # ~23 dB SNR
    _assert_decodes(qpsk_demodulate(noisy, baud=2400))


def test_bpsk_survives_polarity_flip():
    # Differential encoding must make the sign of the waveform irrelevant.
    framed = _frame()
    wave = bpsk_modulate(framed, baud=2400)
    _assert_decodes(bpsk_demodulate(-wave, baud=2400))


def test_qpsk_survives_time_offset():
    framed = _frame()
    wave = qpsk_modulate(framed, baud=2400)
    shifted = np.concatenate([np.zeros(1234, np.float32), wave, np.zeros(500, np.float32)])
    _assert_decodes(qpsk_demodulate(shifted, baud=2400))


def test_fsk_survives_awgn_and_scaling(rng):
    framed = _frame()
    wave = fsk_modulate(framed, baud=1200)
    noisy = 0.3 * wave + rng.normal(0, 0.02, len(wave)).astype(np.float32)
    _assert_decodes(fsk_demodulate(noisy, baud=1200))


def test_int16_quantization_roundtrip():
    # Through the actual WAV sample format (int16) and back.
    framed = _frame()
    wave = qpsk_modulate(framed, baud=9600)
    q = (np.clip(wave, -1, 1) * 32767).astype(np.int16).astype(np.float32) / 32768.0
    _assert_decodes(qpsk_demodulate(q, baud=9600))


# --- full mode registry -------------------------------------------------------

ALL_BYTE_MODES = [m for m in MODES if m not in ("HELLSCHREIBER", "FELD_HELL", "SLOW_HELL")]


@pytest.mark.parametrize("mode", ALL_BYTE_MODES)
def test_every_mode_roundtrips(mode):
    data = PAYLOAD[:120]
    framed = _frame(data)
    rate = 2400
    wave = modulate(mode, framed, rate)
    raw = demodulate(mode, wave, rate)
    _assert_decodes(raw, data)


def test_unknown_mode_demod_falls_back_to_qpsk():
    framed = _frame(PAYLOAD[:60])
    wave = modulate("QPSK", framed, 2400)
    raw = demodulate("NO_SUCH_MODE", wave, 2400)
    _assert_decodes(raw, PAYLOAD[:60])


def test_unknown_mode_modulate_raises():
    with pytest.raises(ValueError):
        modulate("NO_SUCH_MODE", b"x", 1200)


@pytest.mark.parametrize("baud", [2400, 9600])
def test_qpsk_random_payload_roundtrip(baud, rng):
    # Regression: raw-energy timing scores elected a half-symbol-misaligned
    # hypothesis on some payloads (the Gram-inverse dual basis amplifies
    # misaligned projections); phase-coherence scoring must hold for
    # arbitrary payload content.
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    framed = _frame(data)
    wave = qpsk_modulate(framed, baud=baud)
    _assert_decodes(qpsk_demodulate(wave, baud=baud), data)


def test_batched_path_matches_generic_path(rng):
    # The fused dual-stream batch pipeline and the generic bit-stream path
    # must produce identical bytes.
    import jax.numpy as jnp

    from audio_modem_radio.parallel.batch import demod_pack_batch

    data = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    framed = _frame(data)
    wave = qpsk_modulate(framed, baud=9600)
    generic = qpsk_demodulate(wave, baud=9600)
    packed, n_valid, found = demod_pack_batch(jnp.asarray(wave)[None, :], "QPSK", 9600)
    fused = bytes(np.asarray(packed[0])[: int(n_valid[0])])
    assert bool(found[0])
    # The batch path pads captures to whole row tiles, so its byte stream has
    # a longer zero tail; the real content must match exactly.
    assert fused[: len(generic)] == generic
    assert parse_frames(fused)[0].data == data


def test_fsk9600_large_random_payload_mlse(rng):
    # The close-tone discriminator's linear equalizer floors at ~1.5e-5 BER;
    # the CPFSK phase-trellis MLSE refinement makes clean captures exact.
    # 16 KB of random payload (~131k bits) would fail without it.
    data = rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
    framed = _frame(data)
    wave = fsk_modulate(framed, baud=9600)
    _assert_decodes(fsk_demodulate(wave, baud=9600), data)


def test_fsk9600_rotated_channel_equalizer_floor(rng):
    # A channel phase rotation breaks the MLSE waveform model (hundreds of
    # bit errors); the equalizer stream stays near its ~1.5e-5 floor. This
    # pins the EQ path's robustness and, implicitly, what the parse-verified
    # fallback in fsk_demodulate falls back TO.
    import jax.numpy as jnp
    from scipy.signal import hilbert

    from audio_modem_radio.ops.common import bytes_to_bits
    from audio_modem_radio.ops.fsk import fsk_demod_bits

    data = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    framed = _frame(data)
    wave = fsk_modulate(framed, baud=9600)
    z = hilbert(np.asarray(wave, np.float64))
    rotated = (np.real(z * np.exp(1j * 0.7)) * 0.5).astype(np.float32)
    expected = bytes_to_bits(b"\xAA\xAA\xAA\xAA" + framed + b"\xAA")
    bits, _ = fsk_demod_bits(
        jnp.asarray(rotated), 9600.0, 1200.0, 2200.0, 96000, mlse=False
    )
    bits = np.asarray(bits)
    n = min(len(bits), len(expected))
    assert int((bits[:n] != expected[:n]).sum()) <= 5  # ~floor, not model break


def test_fsk9600_long_capture_blocked_mlse(rng):
    """Captures beyond the old 2^18-bit MLSE gate decode bit-exact via the
    block-parallel Viterbi (VERDICT r1 weak #4: long FSK9600 captures
    silently skipped MLSE)."""
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio.ops.fsk import fsk_demodulate, fsk_modulate

    payload = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    framed = pack_frame("big.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(fsk_modulate(framed, 9600), np.float32)
    assert len(wave) // 10 > (1 << 18)  # beyond the old gate
    frames = parse_frames(fsk_demodulate(wave, 9600))
    assert frames and frames[0].data == payload


def test_slow_hell_roundtrip():
    """SLOW_HELL — a reference catalog label with no implementation there —
    is a real mode here: Hellschreiber glyphs at half pixel rate."""
    from audio_modem_radio.modem import MODES, demodulate, modulate

    assert "SLOW_HELL" in MODES
    wave = modulate("SLOW_HELL", b"SLOW HELL 42", 0)
    assert demodulate("SLOW_HELL", wave, 0) == b"SLOW HELL 42"
    # Half the pixel rate => twice the FELD_HELL duration for the same text.
    fast = modulate("FELD_HELL", b"SLOW HELL 42", 0)
    assert abs(len(wave) / len(fast) - 2.0) < 0.05


@pytest.mark.parametrize(
    "mode,rate,spsym",
    [("QPSK", 9600, 10), ("QPSK", 19200, 5), ("BPSK", 9600, 10)],
)
def test_psk_every_timing_offset_with_leading_silence(mode, rate, spsym, rng):
    """Regression (round-3 chaos sweep): leading silence whose length is
    ≢ 0 mod spsym corrupted the frame's LAST dibit (floor-truncated tail
    block) and misled offset selection (dual-basis energy amplification /
    BPSK coherence degeneracy). Every sample offset must decode."""
    payload = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
    framed = pack_frame("o.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate(mode, framed, rate), np.float32)
    for off in range(spsym):
        cap = np.concatenate([np.zeros(137 * spsym + off, np.float32), wave])
        frames = parse_frames(demodulate(mode, cap, rate))
        assert frames and frames[0].data == payload, (mode, rate, off)


def test_fsk_quiet_lead_with_clipping(rng):
    """Regression (round-3 chaos sweep): a long QUIET lead before a clipped
    FSK9600 capture broke MLSE — the branch metrics' amplitude estimate was a
    plain mean over all per-bit magnitudes, so thousands of near-zero noise
    "bits" in the lead dragged â far below the signal amplitude and the
    refinement ADDED errors over its equalizer seed. The energy-weighted
    estimate (Σm²/Σm) must shrug the lead off and decode bit-exact."""
    payload = rng.integers(0, 256, 1400, dtype=np.uint8).tobytes()
    framed = pack_frame("q.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate("FSK9600", framed, 9600), np.float32)
    cap = np.concatenate([np.zeros(26768, np.float32), wave])
    p = float(np.mean(cap**2))
    cap = cap + rng.normal(0, np.sqrt(p / 10**3.1), len(cap)).astype(np.float32)
    cap = np.clip(cap * 1.29, -1, 1).astype(np.float32)
    frames = parse_frames(demodulate("FSK9600", cap, 9600))
    assert frames and frames[0].data == payload
