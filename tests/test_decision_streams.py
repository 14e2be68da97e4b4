"""The batched PSK decision streams (``psk_decision_streams_batch``: blocked
projection einsum + differential + derotation + decision) against the plain
per-symbol numpy receiver of ``plain_reference.py``, and their input
layouts (flat captures, host-shaped rows, int16/int8 rows)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import plain_reference as ref
from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import modulate


def _make_batch(mode, rate, n_captures=2, seed=0):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    framed = pack_frame("k.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate(mode, framed, rate), np.float32)
    n = 1 << int(np.ceil(np.log2(len(wave))))
    batch = np.zeros((n_captures, n), np.float32)
    batch[:, : len(wave)] = wave
    return batch, payload


def _pass1(batch, carrier, n_psk=4):
    """(best, theta) per capture from the shared batched pass 1."""
    from audio_modem_radio.ops.psk import _batch_pass1, _samples_per_symbol

    spsym = _samples_per_symbol(96000, 9600.0)
    b, n = batch.shape
    _x, _r, best, theta = _batch_pass1(
        jnp.asarray(batch), None, b, -(-n // spsym), spsym, carrier, 96000, 8, 0, n_psk=n_psk
    )
    return np.asarray(best), np.asarray(theta), spsym


def _template_pair(spsym, carrier, best):
    from audio_modem_radio.ops.psk import _offset_templates

    T = _offset_templates(spsym, float(carrier), 96000, 8)
    return T[:, 2 * best : 2 * best + 2]


@pytest.mark.parametrize("n_psk", [2, 4])
def test_decision_streams_match_reference(n_psk):
    """XLA decisions == the plain per-symbol receiver at the same (best, θ)
    over the modulated span, except where the reference's decision
    statistic sits within float32 rounding of a boundary."""
    from audio_modem_radio.ops.psk import psk_decision_streams_batch

    mode = "QPSK" if n_psk == 4 else "BPSK"
    batch, _ = _make_batch(mode, 9600, seed=n_psk)
    batch[1] = np.roll(batch[1], 7)  # distinct winning offsets
    hi, lo = psk_decision_streams_batch(jnp.asarray(batch), 9600.0, 3000.0, 96000, n_psk, True)
    hi, lo = np.asarray(hi), np.asarray(lo)
    best, theta, spsym = _pass1(batch, 3000.0)
    for i in range(2):
        rh, rl, d = ref.psk_decisions(
            batch[i], spsym, _template_pair(spsym, 3000.0, int(best[i])), float(theta[i]), n_psk
        )
        n_sig = len(batch[i]) // spsym - 2
        scale = np.median(np.abs(d[:n_sig]))
        if n_psk == 4:
            margin = np.abs(np.abs(d.real) - np.abs(d.imag))
            tie = np.minimum(margin, np.minimum(np.abs(d.real), np.abs(d.imag)))
            streams = ((hi, rh), (lo, rl))
        else:
            tie = np.abs(d.real)  # lo is the sign of ~0 on DBPSK: not data
            streams = ((hi, rh),)
        ok = tie[:n_sig] > 1e-4 * scale
        for got, want in streams:
            assert np.array_equal(got[i, :n_sig][ok], want[:n_sig][ok])


def test_psk8_sectors_match_reference():
    """psk8_sector_rows_batch == nearest-π/4 sectors of the plain receiver's
    derotated differentials, on the modulated span."""
    from audio_modem_radio.ops.psk import psk8_sector_rows_batch

    batch, _ = _make_batch("8PSK", 9600, seed=8)
    batch[1] = np.roll(batch[1], 5)
    sec = np.asarray(psk8_sector_rows_batch(jnp.asarray(batch), 9600.0, 12000.0, 96000))
    best, _theta, spsym = _pass1(batch, 12000.0, n_psk=8)
    for i in range(2):
        _h, _l, d = ref.psk_decisions(
            batch[i], spsym, _template_pair(spsym, 12000.0, int(best[i])), 0.0, 4
        )
        n_sig = len(batch[i]) // spsym - 2
        d = d[:n_sig]
        w = np.abs(d) ** 2 * np.exp(8j * np.angle(d))  # blind 8th-power estimate
        d = d * np.exp(-1j * np.angle(w.sum()) / 8)
        want = ref.psk8_sectors(d)
        frac = np.angle(d) / (np.pi / 4)
        ok = np.abs(frac - np.round(frac) - 0.5 * np.sign(frac - np.round(frac))) > 1e-4
        ok &= np.abs(d) > 1e-3 * np.median(np.abs(d))
        assert np.mean(sec[i, :n_sig][ok] == want[ok]) == 1.0


def test_psk8_sector_rows_batch_decodes():
    """psk8_sector_rows_batch feeds the sync tail to a bit-exact decode."""
    from audio_modem_radio.parallel.batch import _psk8_sync_tail
    from audio_modem_radio.ops.psk import psk8_sector_rows_batch

    batch, payload = _make_batch("8PSK", 9600, n_captures=2, seed=3)
    sec = psk8_sector_rows_batch(jnp.asarray(batch), 9600.0, 12000.0, 96000)
    packed, n_valid, found = _psk8_sync_tail(sec, True)
    for i in range(2):
        assert bool(found[i])
        frames = parse_frames(np.asarray(packed[i])[: int(n_valid[i])].tobytes())
        assert frames and frames[0].data == payload


@pytest.mark.parametrize("n_psk", [2, 4])
def test_decision_streams_flat_equals_rows(n_psk):
    """Flat (B, N) captures and host-shaped (B, r, 128*spsym) rows of the
    same samples give identical decisions."""
    from audio_modem_radio.ops.psk import psk_decision_streams_batch
    from audio_modem_radio.parallel.batch import host_shape_batch

    mode = "QPSK" if n_psk == 4 else "BPSK"
    batch, _ = _make_batch(mode, 9600, seed=11 + n_psk)
    batch[1] = np.roll(batch[1], 7)
    rows = host_shape_batch(batch, mode, 9600)
    assert rows.ndim == 3 and rows.dtype == np.float32
    a = psk_decision_streams_batch(jnp.asarray(batch), 9600.0, 3000.0, 96000, n_psk, True)
    b = psk_decision_streams_batch(jnp.asarray(rows), 9600.0, 3000.0, 96000, n_psk, True)
    n = min(a[0].shape[1], b[0].shape[1])
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x)[:, :n], np.asarray(y)[:, :n])


@pytest.mark.parametrize("bits", [16, 8])
def test_decision_streams_integer_rows_equal(bits):
    """int16 / int8 rows == float32 rows holding the same quantized values:
    the einsum casts to f32 exactly, so only the transfer width changes."""
    from audio_modem_radio.ops.psk import psk_decision_streams_batch

    dtype, scale = (np.int16, 32768.0) if bits == 16 else (np.int8, 128.0)
    batch, _ = _make_batch("QPSK", 9600, seed=21 + bits)
    lim = np.iinfo(dtype)
    q = np.clip(np.round(batch * scale), lim.min, lim.max)
    spsym = 10
    r0 = -(-(batch.shape[1] // spsym) // 128)
    r = max(256, -(-r0 // 256) * 256)
    rows = np.zeros((2, r * 128 * spsym), np.float32)
    rows[:, : batch.shape[1]] = q
    rows = rows.reshape(2, r, 128 * spsym)
    a = psk_decision_streams_batch(jnp.asarray(rows), 9600.0, 3000.0, 96000, 4, True)
    b = psk_decision_streams_batch(jnp.asarray(rows.astype(dtype)), 9600.0, 3000.0, 96000, 4, True)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("key,dtype", [("device.int8_rows", np.int8), ("device.int16_rows", np.int16)])
def test_integer_rows_e2e_decode(key, dtype):
    """decode_sample_batch with CONFIG ``key`` on: host shaping emits integer
    rows and the frame still round-trips."""
    from audio_modem_radio.config import CONFIG
    from audio_modem_radio.parallel.batch import decode_sample_batch, host_shape_batch

    batch, payload = _make_batch("QPSK", 9600, n_captures=2, seed=34)
    old = CONFIG.get(key, False)
    CONFIG.set(key, True)
    try:
        shaped = host_shape_batch(batch, "QPSK", 9600)
        assert shaped.dtype == dtype and shaped.ndim == 3
        raws = decode_sample_batch(batch, "QPSK", 9600)
    finally:
        CONFIG.set(key, old)
    for raw in raws:
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload


def test_rows_ship_float32_by_default():
    """Without the opt-in keys, PSK rows ship as float32."""
    from audio_modem_radio.parallel.batch import host_shape_batch

    batch, _ = _make_batch("BPSK", 9600, seed=35)
    assert host_shape_batch(batch, "BPSK", 9600).dtype == np.float32


@pytest.mark.parametrize("cfo", [True, False])
def test_decision_streams_batch_decodes(cfo):
    """Decision streams -> dibit sync tail -> every capture's frame."""
    from audio_modem_radio.ops.psk import psk_decision_streams_batch
    from audio_modem_radio.parallel.batch import _dibit_sync_tail

    batch, payload = _make_batch("QPSK", 9600, n_captures=3, seed=7)
    hi, lo = psk_decision_streams_batch(jnp.asarray(batch), 9600.0, 3000.0, 96000, 4, cfo)
    packed, n_valid, found = _dibit_sync_tail(hi, lo, cfo)
    assert bool(np.asarray(found).all())
    for i in range(batch.shape[0]):
        raw = np.asarray(packed[i])[: int(n_valid[i])].tobytes()
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload
