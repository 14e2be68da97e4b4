"""Tests for the analytic front-end variants and block-parallel Viterbi.

Covers round-2 perf work: the exact decimated brick-wall front end, the
overlap-save FIR alternative, host-overlapped FSK rows, and the blocked
Viterbi's equivalence with the sequential decoder on long streams.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from audio_modem_radio.ops.common import (
    _analytic_fir_taps,
    analytic_bandpass,
    analytic_bandpass_fir,
)


def test_analytic_fir_matches_numpy_convolution():
    rng = np.random.default_rng(0)
    n, taps = 5000, 257
    x = rng.standard_normal(n).astype(np.float32)
    z = np.asarray(analytic_bandpass_fir(jnp.asarray(x), 10.0, 11800.0, 96000, taps=taps))
    h = _analytic_fir_taps(10.0, 11800.0, 96000, taps)
    c = (taps - 1) // 2
    ref = np.convolve(x.astype(np.float64), h.astype(np.complex128), mode="full")[c : c + n]
    assert np.max(np.abs(z - ref)) < 1e-5 * np.max(np.abs(ref))


def test_analytic_fir_multiblock_overlap_save():
    # Longer than one OLS block: exercises the overlap-save stitching.
    rng = np.random.default_rng(1)
    n, taps = (1 << 17) + 12345, 1025
    x = rng.standard_normal(n).astype(np.float32)
    z = np.asarray(
        analytic_bandpass_fir(jnp.asarray(x), 100.0, 8000.0, 96000, taps=taps, block=1 << 15)
    )
    h = _analytic_fir_taps(100.0, 8000.0, 96000, taps)
    c = (taps - 1) // 2
    m = 1 << 18
    ref = np.fft.ifft(np.fft.fft(x, m) * np.fft.fft(h, m))[c : c + n]
    assert np.max(np.abs(z - ref)) < 1e-5 * np.max(np.abs(ref))


@pytest.mark.parametrize("dec", [2, 4, 8])
def test_analytic_decimation_is_exact(dec):
    rng = np.random.default_rng(2)
    n = 100000  # pads to 2^17; all powers of two divide it
    x = rng.standard_normal(n).astype(np.float32)
    z1 = np.asarray(analytic_bandpass(jnp.asarray(x), 10.0, 11000.0, 96000))
    zd = np.asarray(analytic_bandpass(jnp.asarray(x), 10.0, 11000.0, 96000, decimate=dec))
    ref = z1[::dec]
    assert zd.shape[0] == -(-n // dec)
    assert np.max(np.abs(zd[: len(ref)] - ref)) < 1e-5 * np.max(np.abs(ref))


def test_analytic_decimation_rejects_aliasing_band():
    x = jnp.zeros(4096, jnp.float32)
    with pytest.raises(ValueError):
        analytic_bandpass(x, 10.0, 30000.0, 96000, decimate=4)


def test_fsk_pre_shaped_rows_match_flat():
    from audio_modem_radio.ops.fsk import (
        fsk_blocked_row_shape,
        fsk_demod_bits,
        fsk_modulate,
    )

    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
    wave = np.asarray(fsk_modulate(payload, 1200, 1200.0, 2200.0), np.float32)
    n = len(wave)
    bits_flat, _ = fsk_demod_bits(jnp.asarray(wave), 1200.0, 1200.0, 2200.0, 96000)

    r, row, ov = fsk_blocked_row_shape(n, 1200.0, 1200.0, 2200.0, 96000)
    flat = np.zeros((r + 1) * row, np.float32)
    flat[:n] = wave
    shaped = np.empty((r, row + ov), np.float32)
    shaped[:, :row] = flat[: r * row].reshape(r, row)
    shaped[:, row:] = flat[row : (r + 1) * row].reshape(r, row)[:, :ov]
    bits_pre, _ = fsk_demod_bits(jnp.asarray(shaped), 1200.0, 1200.0, 2200.0, 96000)

    nb = bits_flat.shape[0]
    assert np.array_equal(np.asarray(bits_pre)[:nb], np.asarray(bits_flat))


def test_fsk9600_discriminator_decimation_active_and_exact():
    # The production FSK9600 config decimates by 2 and must still decode
    # clean captures bit-exactly through the equalizer path (mlse=False).
    from audio_modem_radio.ops.common import bytes_to_bits
    from audio_modem_radio.ops.fsk import (
        FSK_PREAMBLE,
        _discriminator_decimation,
        fsk_demod_bits,
        fsk_modulate,
    )

    assert _discriminator_decimation(10, 11800.0, 96000) >= 2
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    wave = np.asarray(fsk_modulate(payload, 9600, 1200.0, 2200.0), np.float32)
    bits, _ = fsk_demod_bits(jnp.asarray(wave), 9600.0, 1200.0, 2200.0, 96000, mlse=False)
    true_bits = bytes_to_bits(FSK_PREAMBLE + payload + b"\xAA")
    got = np.asarray(bits)[: len(true_bits)]
    assert np.array_equal(got, true_bits[: len(got)])


def test_blocked_viterbi_matches_sequential_long_stream():
    from audio_modem_radio.fec import (
        _VIT_CORE,
        _VIT_OV,
        ConvolutionalEncoder,
        _trellis_tables,
        _viterbi_block,
        viterbi_decode_bits,
    )

    rng = np.random.default_rng(5)
    n_bits = _VIT_CORE * 2 + 777  # forces >= 3 blocks
    data = rng.integers(0, 2, n_bits, dtype=np.uint8)
    pairs = ConvolutionalEncoder().encode_bits(data).astype(np.float32)
    # ~1% soft noise so the comparison isn't trivially all-zero metrics.
    noise_idx = rng.choice(pairs.size, pairs.size // 100, replace=False)
    flat = pairs.reshape(-1).copy()
    flat[noise_idx] = 1.0 - flat[noise_idx]
    pairs = flat.reshape(-1, 2)

    blocked = np.asarray(viterbi_decode_bits(jnp.asarray(pairs), known_boundaries=False))
    seq = np.asarray(
        _viterbi_block(jnp.asarray(pairs), jnp.zeros(64), from_best_end=True)
    )
    # Both must recover the true data (the code corrects 1% errors easily).
    assert np.array_equal(blocked[: n_bits], data)
    assert np.array_equal(seq[: n_bits], data)


def test_stream_fec_long_payload_roundtrip():
    from audio_modem_radio.fec import stream_fec_decode, stream_fec_encode
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames

    rng = np.random.default_rng(6)
    payload = rng.integers(0, 256, 120000, dtype=np.uint8).tobytes()
    framed = pack_frame("big.bin", payload, 0, 1, len(payload), crc32(payload))
    coded = stream_fec_encode(framed)
    out = stream_fec_decode(b"\x3c\x11" + coded + b"\xee")
    frames = parse_frames(out)
    assert frames and frames[0].data == payload


# --- round 3: decimating matmul FIR front end -------------------------------

from audio_modem_radio.ops.common import analytic_bandpass_fir_dec


@pytest.mark.parametrize("dec,taps", [(1, 129), (2, 257), (4, 513)])
def test_matmul_fir_dec_equals_strided_fir(dec, taps):
    """analytic_bandpass_fir_dec == analytic_bandpass_fir(x)[::dec] exactly
    (same taps, decimating convolution folded into one matmul)."""
    rng = np.random.default_rng(7)
    n = 50_000 + 37  # deliberately not a row multiple
    x = rng.standard_normal(n).astype(np.float32)
    lo, hi = 10.0, 11800.0
    zr, zi = analytic_bandpass_fir_dec(jnp.asarray(x), lo, hi, 96000, dec, taps=taps)
    ref = np.asarray(analytic_bandpass_fir(jnp.asarray(x), lo, hi, 96000, taps=taps))
    ref = ref[::dec]
    got = np.asarray(zr) + 1j * np.asarray(zi)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref)) + 1e-12
    assert np.max(np.abs(got - ref)) < 2e-4 * scale


def test_matmul_fir_dec_batched():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    zr, zi = analytic_bandpass_fir_dec(jnp.asarray(x), 100.0, 11800.0, 96000, 4)
    zr1, zi1 = analytic_bandpass_fir_dec(jnp.asarray(x[1]), 100.0, 11800.0, 96000, 4)
    assert np.allclose(np.asarray(zr)[1], np.asarray(zr1), atol=1e-5)
    assert np.allclose(np.asarray(zi)[1], np.asarray(zi1), atol=1e-5)


def test_matmul_fir_dec_geometry_guard():
    with pytest.raises(ValueError):
        analytic_bandpass_fir_dec(jnp.zeros(4096), 10.0, 11800.0, 96000, 1, taps=513)


@pytest.mark.parametrize(
    "baud,mark,space",
    [(9600, 1200.0, 2200.0), (19200, 8000.0, 16000.0), (1200, 1200.0, 2200.0)],
)
def test_fsk_matmul_frontend_roundtrip_all_families(baud, mark, space):
    """The production default frontend='matmul' decodes bit-exact on clean audio in every FSK family, and
    agrees with the fft front end."""
    from audio_modem_radio.framing import crc32, pack_frame
    from audio_modem_radio.ops.common import bytes_to_bits
    from audio_modem_radio.ops.fsk import FSK_PREAMBLE, fsk_demod_bits, fsk_modulate

    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    framed = pack_frame("m.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(fsk_modulate(framed, baud, mark, space), np.float32)
    exp = bytes_to_bits(FSK_PREAMBLE + framed)
    for fe in ("matmul", "fft"):
        bits, _ = fsk_demod_bits(wave, float(baud), mark, space, 96000, mlse=False, frontend=fe)
        bits = np.asarray(bits)
        n = min(len(bits), len(exp))
        errs = int((bits[:n] != exp[:n]).sum())
        # FSK9600 (mod index 0.1) has a known ~1.5e-5 equalizer residual
        # floor with mlse=False (ops/fsk.py); allow single-bit residuals —
        # clean-audio file round-trips run MLSE and are exact.
        assert errs <= 3, f"frontend {fe}: {errs} bit errors on clean audio"


@pytest.mark.parametrize(
    "baud,mark,space",
    [(9600.0, 1200.0, 2200.0), (19200.0, 8000.0, 16000.0)],
)
def test_fsk_fir_pre_shaped_rows_match_flat(baud, mark, space):
    """Host-built FIR front-end windows must yield BIT-EQUAL output to the
    flat path (same windows, same template, same op order) for both the
    discriminator (FSK9600, dec=4) and the mid-separation matched filter
    (FSK19200, dec=1)."""
    from audio_modem_radio.ops.fsk import (
        fsk_demod_bits,
        fsk_fir_row_shape,
        fsk_modulate,
    )
    from audio_modem_radio.parallel.batch import _overlap_rows

    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
    wave = np.asarray(fsk_modulate(payload, baud, mark, space), np.float32)
    wave = wave + 0.02 * rng.standard_normal(len(wave)).astype(np.float32)

    bits_flat, _ = fsk_demod_bits(
        jnp.asarray(wave), baud, mark, space, 96000, mlse=False
    )

    shape = fsk_fir_row_shape(len(wave), baud, mark, space, 96000)
    assert shape is not None
    r, row, ov, lead = shape
    shaped = _overlap_rows(wave[None, :], r, row, ov, lead=lead)[0]
    bits_pre, _ = fsk_demod_bits(
        jnp.asarray(shaped), baud, mark, space, 96000, mlse=False
    )

    nb = min(bits_flat.shape[0], bits_pre.shape[0])
    assert np.array_equal(np.asarray(bits_pre)[:nb], np.asarray(bits_flat)[:nb])
    assert bits_pre.shape[0] >= bits_flat.shape[0]


def test_fsk_fir_pre_shaped_rejects_mlse_and_dual_tone():
    from audio_modem_radio.ops.fsk import fsk_demod_bits, fsk_fir_row_shape

    # Dual-tone configs have no FIR-row geometry (detector rows cover them).
    assert fsk_fir_row_shape(96000, 1200.0, 1200.0, 2200.0, 96000) is None
    shape = fsk_fir_row_shape(96000, 9600.0, 1200.0, 2200.0, 96000)
    r, row, ov, _lead = shape
    rows = jnp.zeros((r, row + ov), jnp.float32)
    with pytest.raises(ValueError, match="MLSE"):
        fsk_demod_bits(rows, 9600.0, 1200.0, 2200.0, 96000, mlse=True)
