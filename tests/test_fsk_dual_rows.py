"""Dual-tone FSK over host-shaped pre-overlapped rows
(``fsk_dual_bits_rows_batch``: pass-1 offset scoring + one pass-2 einsum)
against the plain per-bit energy detector of ``plain_reference.py``, and
the end-to-end decode through the batch surface."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import plain_reference as ref
from audio_modem_radio.framing import MAGIC_BIT_PATTERN, crc32, pack_frame, parse_frames
from audio_modem_radio.modem import SAMPLE_RATE
from audio_modem_radio.ops.fsk import (
    _fsk_blocked_templates,
    _fsk_geometry,
    _samples_per_bit,
    fsk_dual_bits_rows_batch,
    fsk_modulate,
)
from audio_modem_radio.parallel.batch import _overlap_rows


BAUD, MARK, SPACE = 1200.0, 1200.0, 2200.0


def _rows_batch(n_captures=2, seed=0, baud=BAUD, r_target=256, quantize=False):
    rng = np.random.default_rng(seed)
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    spr, row, ov = _fsk_geometry(spb)
    payload = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    framed = pack_frame("f.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(fsk_modulate(framed, baud, MARK, SPACE, SAMPLE_RATE), np.float32)
    n = r_target * row
    batch = 0.01 * rng.normal(size=(n_captures, n)).astype(np.float32)
    for i in range(n_captures):
        # different leading offsets so the winning timing offset differs
        off = (i * spb) // 3 + i
        batch[i, off : off + len(wave)] += wave[: n - off]
    if quantize:
        batch = np.round(batch * 32768.0) / 32768.0
    return _overlap_rows(batch, r_target, row, ov), payload, spb


def _reference_bits(rows, baud, best):
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    spr, _row, _ov = _fsk_geometry(spb)
    W = _fsk_blocked_templates(spb, MARK, SPACE, SAMPLE_RATE, 8)
    return ref.fsk_dual_bits(rows, W, best, spr)


def _best_offsets(rows, baud):
    """Winning offset per capture: the plain reference of pass 1 (sum of
    |mark - space| energy margins over three 32-row windows)."""
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    spr, _row, _ov = _fsk_geometry(spb)
    W = np.asarray(_fsk_blocked_templates(spb, MARK, SPACE, SAMPLE_RATE, 8), np.float64)
    r = rows.shape[1]
    wr = min(32, r)
    starts = sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)})
    best = []
    for cap in rows:
        win = np.concatenate([cap[s : s + wr] for s in starts]).astype(np.float64)
        pj = np.einsum("rc,kcn->rkn", win, W).reshape(len(win), 8, 4, spr)
        score = np.abs(pj[:, :, 0] ** 2 + pj[:, :, 1] ** 2 - pj[:, :, 2] ** 2 - pj[:, :, 3] ** 2)
        best.append(int(np.argmax(score.sum(axis=(0, 2)))))
    return best


@pytest.mark.parametrize("quantize", [False, True])
def test_dual_rows_match_reference(quantize):
    """XLA bits == the plain per-bit energy detector at the reference's own
    winning offsets, for float rows and int16-valued rows."""
    rows, _payload, _spb = _rows_batch(quantize=quantize)
    got = np.asarray(fsk_dual_bits_rows_batch(jnp.asarray(rows), BAUD, MARK, SPACE, SAMPLE_RATE))
    for i, best in enumerate(_best_offsets(rows, BAUD)):
        want = _reference_bits(rows[i], BAUD, best)
        assert np.mean(got[i] != want) < 1e-3  # float32 vs float64 at noise-only bits


def test_dual_rows_int16_equals_f32_on_quantized():
    """int16 rows == f32 rows holding the same quantized values, bitwise."""
    rows, _p, _spb = _rows_batch(seed=3, quantize=True)
    q = np.round(rows * 32768.0).astype(np.int16)
    bits_i = fsk_dual_bits_rows_batch(jnp.asarray(q), BAUD, MARK, SPACE, SAMPLE_RATE)
    bits_f = fsk_dual_bits_rows_batch(
        jnp.asarray(q.astype(np.float32)), BAUD, MARK, SPACE, SAMPLE_RATE
    )
    assert np.array_equal(np.asarray(bits_i), np.asarray(bits_f))


@pytest.mark.parametrize("quantize", [False, True])
def test_dual_rows_e2e_frame(quantize):
    """Bits from the rows path parse back to the transmitted frame."""
    from audio_modem_radio.ops.common import find_bit_pattern, pack_bits_from

    rows, payload, _spb = _rows_batch(seed=5, quantize=quantize)
    bits = fsk_dual_bits_rows_batch(jnp.asarray(rows), BAUD, MARK, SPACE, SAMPLE_RATE)

    def sync_pack(bb):
        start, found = find_bit_pattern(bb, MAGIC_BIT_PATTERN)
        packed, n_valid = pack_bits_from(bb, start)
        return packed, n_valid, found

    packed, n_valid, found = jax.vmap(sync_pack)(bits)
    assert bool(np.asarray(found).all())
    for i in range(rows.shape[0]):
        raw = np.asarray(packed[i])[: int(n_valid[i])].tobytes()
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload


def test_dual_rows_geometries():
    """Row geometry: whole bits per row, 128-aligned rows, an overlap tail
    that covers one bit window."""
    for baud in (1200.0, 50.0, SAMPLE_RATE / 128.0):
        spb = _samples_per_bit(SAMPLE_RATE, baud)
        spr, row, ov = _fsk_geometry(spb)
        assert row == spr * spb and row % 128 == 0
        assert ov >= spb and ov % 128 == 0


def test_dual_rows_non_dividing_spr_decodes():
    """MSK@1000 Bd geometry (spb=96 -> spr=12, which does not divide 128)
    runs the same einsum path and matches the reference."""
    baud = 1000.0
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    spr, _row, _ov = _fsk_geometry(spb)
    assert spr == 12 and 128 % spr != 0
    rows, _payload, _spb = _rows_batch(seed=12, baud=baud)
    got = np.asarray(fsk_dual_bits_rows_batch(jnp.asarray(rows), baud, MARK, SPACE, SAMPLE_RATE))
    for i, best in enumerate(_best_offsets(rows, baud)):
        assert np.mean(got[i] != _reference_bits(rows[i], baud, best)) < 1e-3


def test_dual_rows_reject_wrong_columns():
    spb = _samples_per_bit(SAMPLE_RATE, BAUD)
    spr, row, ov = _fsk_geometry(spb)
    x = jnp.zeros((1, 4, row + ov + 1), jnp.float32)
    with pytest.raises(ValueError, match="row\\+ov"):
        fsk_dual_bits_rows_batch(x, BAUD, MARK, SPACE, SAMPLE_RATE)


def test_dual_rows_match_reference_spr8():
    """A second geometry (spb=128 -> spr=8) against the reference."""
    baud = SAMPLE_RATE / 128.0
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    spr, _row, _ov = _fsk_geometry(spb)
    assert spr == 8
    rows, _payload, _spb = _rows_batch(seed=11, baud=baud)
    got = np.asarray(fsk_dual_bits_rows_batch(jnp.asarray(rows), baud, MARK, SPACE, SAMPLE_RATE))
    for i, best in enumerate(_best_offsets(rows, baud)):
        assert np.mean(got[i] != _reference_bits(rows[i], baud, best)) < 1e-3


def test_fsk_batch_surface_still_decodes():
    """decode_sample_batch FSK1200 end to end (host-shaped dual-tone rows)."""
    from audio_modem_radio.parallel.batch import decode_sample_batch

    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
    framed = pack_frame("g.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(fsk_modulate(framed, BAUD, MARK, SPACE, SAMPLE_RATE), np.float32)
    n = 1 << int(np.ceil(np.log2(len(wave))))
    batch = np.zeros((2, n), np.float32)
    batch[:, : len(wave)] = wave
    raws = decode_sample_batch(batch, "FSK1200", 1200)
    for raw in raws:
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload
