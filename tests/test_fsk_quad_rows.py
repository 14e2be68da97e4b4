"""Mid-separation FSK (FSK19200, the quadrature matched-filter config) over the matmul FIR
front end's host-shaped windows (``fsk_fir_row_shape`` rows, the layout
``host_shape_batch`` ships): the decimating FIR matmul against a plain
``np.convolve`` reference, and the rows path's bits against the flat
single-capture receiver."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import plain_reference as ref
from audio_modem_radio.framing import MAGIC_BIT_PATTERN, crc32, pack_frame, parse_frames
from audio_modem_radio.modem import SAMPLE_RATE
from audio_modem_radio.ops.common import _analytic_fir_taps, analytic_fir_dec_rows
from audio_modem_radio.ops.fsk import (
    _fir_frontend_plan,
    _samples_per_bit,
    _separation_cycles,
    fsk_demod_bits,
    fsk_fir_row_shape,
    fsk_modulate,
)
from audio_modem_radio.parallel.batch import _overlap_rows

BAUD, MARK, SPACE = 19200.0, 8000.0, 16000.0
SEPARATION = (0.4, 0.8)  # mid-separation configs
N_SAMPLES = 1 << 17


def _capture(n, seed=0, payload_len=600, lead=0):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, payload_len, dtype=np.uint8).tobytes()
    framed = pack_frame("q.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(fsk_modulate(framed, BAUD, MARK, SPACE, SAMPLE_RATE), np.float32)
    sig = np.zeros(n, np.float32)
    m = min(n - lead, len(wave))
    sig[lead : lead + m] = wave[:m]
    return sig, payload


def _rows(batch):
    r, rowl, ov, lead = fsk_fir_row_shape(batch.shape[1], BAUD, MARK, SPACE, SAMPLE_RATE)
    return _overlap_rows(batch, r, rowl, ov, lead=lead)


def _rows_bits(rows):
    return np.asarray(
        jax.vmap(lambda x: fsk_demod_bits(x, BAUD, MARK, SPACE, SAMPLE_RATE, mlse=False)[0])(
            jnp.asarray(rows)
        )
    )


def _flat_bits(sig):
    return np.asarray(fsk_demod_bits(jnp.asarray(sig), BAUD, MARK, SPACE, SAMPLE_RATE, mlse=False)[0])


def test_fir_rows_plan():
    """The config is a mid-separation one and its FIR rows hold 128
    decimated outputs plus the tap overlap."""
    sep = _separation_cycles(BAUD, MARK, SPACE, SAMPLE_RATE)
    assert SEPARATION[0] <= sep < SEPARATION[1]
    _lo, _hi, dec, taps = _fir_frontend_plan(BAUD, MARK, SPACE, SAMPLE_RATE)
    r, rowl, ov, lead = fsk_fir_row_shape(1 << 17, BAUD, MARK, SPACE, SAMPLE_RATE)
    assert rowl == 128 * dec and ov == taps - dec and lead == (taps - 1) // 2
    assert r * 128 * dec >= 1 << 17


@pytest.mark.parametrize("lead", [0, 7])
def test_fir_rows_match_flat(lead):
    """Rows path bits == the flat receiver's over the signal span (the
    rows are the windows the flat path builds on the device)."""
    n = N_SAMPLES
    sig, _ = _capture(n, seed=1 + lead, lead=lead)
    got = _rows_bits(_rows(sig[None, :]))[0]
    want = _flat_bits(sig)
    n_sig = n // _samples_per_bit(SAMPLE_RATE, BAUD) - 2
    assert np.array_equal(got[:n_sig], want[:n_sig])


def test_fir_matmul_matches_convolution():
    """The decimating FIR matmul over host rows == np.convolve with the same
    complex taps, decimated (float32 vs float64 tolerance)."""
    n = 1 << 15
    sig, _ = _capture(n, seed=2)
    lo_hz, hi_hz, dec, taps = _fir_frontend_plan(BAUD, MARK, SPACE, SAMPLE_RATE)
    zr, zi = analytic_fir_dec_rows(
        jnp.asarray(_rows(sig[None, :])[0]), lo_hz, hi_hz, SAMPLE_RATE, dec, taps
    )
    want = ref.fir_decimate(sig, _analytic_fir_taps(lo_hz, hi_hz, SAMPLE_RATE, taps), dec)
    got = np.asarray(zr)[: len(want)] + 1j * np.asarray(zi)[: len(want)]
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))


@pytest.mark.parametrize("lead", [0, 5])
def test_fir_rows_e2e_frame(lead):
    from audio_modem_radio.ops.common import find_bit_pattern, pack_bits_from

    n = N_SAMPLES
    sig, payload = _capture(n, seed=5, lead=lead)
    bits = jnp.asarray(_rows_bits(_rows(np.stack([sig, sig]))))

    def sync_pack(bb):
        start, found = find_bit_pattern(bb, MAGIC_BIT_PATTERN)
        packed, n_valid = pack_bits_from(bb, start)
        return packed, n_valid, found

    packed, n_valid, found = jax.vmap(sync_pack)(bits)
    assert bool(np.asarray(found).all())
    for i in range(2):
        raw = np.asarray(packed[i])[: int(n_valid[i])].tobytes()
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload


def test_fir_rows_noisy_parity_with_flat():
    """At 15 dB the rows path's decisions track the flat receiver's on the
    same noisy capture."""
    n = N_SAMPLES
    sig, _ = _capture(n, seed=7, payload_len=2000)
    rng = np.random.default_rng(99)
    snr = 10 ** (15 / 10)
    noisy = sig + rng.normal(0, np.sqrt(np.mean(sig**2) / snr), n).astype(np.float32)
    got = _rows_bits(_rows(noisy[None, :]))[0]
    want = _flat_bits(noisy)
    n_sig = n // _samples_per_bit(SAMPLE_RATE, BAUD) - 2
    assert np.mean(got[:n_sig] != want[:n_sig]) < 5e-3


def test_batch_surface_decodes():
    """decode_sample_batch through the host-shaped FIR rows."""
    from audio_modem_radio.parallel.batch import decode_sample_batch, host_shape_batch

    n = N_SAMPLES // 2
    sig, payload = _capture(n, seed=11, payload_len=300)
    batch = np.stack([sig, sig])
    assert host_shape_batch(batch, "FSK19200", 19200).ndim == 3
    raws = decode_sample_batch(batch, "FSK19200", 19200)
    for raw in raws:
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload
