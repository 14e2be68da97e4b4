"""D8PSK sync tail (``psk8_sync_and_pack_rotations`` vmapped as in
``demod_pack_batch``) and banded relabel+pack against the plain numpy
references of ``plain_reference.py``, per rotation hypothesis.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import plain_reference as ref
from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.ops.common import bytes_to_bits
from audio_modem_radio.ops.psk import _GRAY8_INV, psk8_relabel_pack_batch
from audio_modem_radio.parallel.batch import _psk8_sync_tail


def _sectors_from_bytes(data: bytes, lead_symbols: int, k: int, m: int, rng,
                        junk: int = 256):
    """A received sector stream carrying ``data``'s tribits under channel
    rotation k. ``data`` is zero-padded to a whole number of tribits (the
    parser ignores the trailing pad, like a real modulator's bit pad). A
    short random-junk window precedes the lead; the rest is constant sector
    0 — an unbounded uniform-random filler would statistically produce a
    tol-3 false accept on SOME rotation hypothesis (~1 expected per 32k
    symbols), which is channel physics, not a tail property under test."""
    data = data + b"\x00" * ((3 - len(data) % 3) % 3)
    bits = bytes_to_bits(data)
    n_sym = len(bits) // 3
    tris = (
        bits[: n_sym * 3].reshape(n_sym, 3) @ np.array([4, 2, 1], np.uint8)
    ).astype(np.uint8)
    true = _GRAY8_INV[tris].astype(np.int32)
    rx = ((true + k) % 8).astype(np.uint8)
    out = np.zeros(m, dtype=np.uint8)
    out[max(0, lead_symbols - junk) : lead_symbols] = rng.integers(
        0, 8, min(junk, lead_symbols), dtype=np.uint8
    )
    out[lead_symbols : lead_symbols + n_sym] = rx
    return out


def _tail(sec, cfo_retry=True):
    packed, n_valid, found = _psk8_sync_tail(jnp.asarray(sec), cfo_retry)
    packed, n_valid, found = np.asarray(packed), np.asarray(n_valid), np.asarray(found)
    return [
        (bytes(packed[i][: int(n_valid[i])]), bool(found[i])) for i in range(len(sec))
    ]


@pytest.mark.parametrize("k", [0, 1, 3, 5, 7])
def test_sector_sync_finds_rotated_magic(k, rng):
    """Rotation k at two leads: the tail syncs, its bytes equal the plain
    reference's and parse to the frame; a random stream matches nothing."""
    m = 256 * 128
    payload = b"payload" * 40
    frame = pack_frame("t.bin", payload, 0, 1, len(payload), crc32(payload))
    sec = np.stack([_sectors_from_bytes(frame, lead, k, m, rng) for lead in (37, 1000)])
    for i, (raw, found) in enumerate(_tail(sec)):
        want, want_found = ref.psk8_sync(sec[i])
        assert found and want_found and raw == want
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload
    junk = rng.integers(0, 8, (1, m), dtype=np.uint8)
    assert not _tail(junk)[0][1]
    assert not ref.psk8_sync(junk[0])[1]


@pytest.mark.parametrize("k", [0, 2, 6])
def test_sync_tail_matches_reference(k, rng):
    """Two captures at different rotations: bytes and found equal the plain
    reference per capture, and both parse the payload."""
    m = 256 * 128
    payload = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    frame = pack_frame("k.bin", payload, 0, 1, len(payload), crc32(payload))
    sec = np.stack([
        _sectors_from_bytes(frame, 11, k, m, rng),
        _sectors_from_bytes(frame, 801, (k + 3) % 8, m, rng),
    ])
    for i, (raw, found) in enumerate(_tail(sec)):
        want, want_found = ref.psk8_sync(sec[i])
        assert found == want_found and raw == want
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload


def test_relabel_pack_matches_pack_bits_from(rng):
    """The banded pack einsum equals gray-bits + pack_bits_from per capture,
    offset by the whole-byte remainder the mod-8 contract leaves to the
    parser's magic scan: the shift applies only idx % 8 symbols, so
    pack_bits_from(bits, 3*idx)'s stream begins at byte 3*(idx // 8) of the
    banded stream."""
    from audio_modem_radio.ops.common import pack_bits_from
    from audio_modem_radio.ops.psk import _psk8_gray_bits

    b, m = 3, 128 * 16
    sec = rng.integers(0, 8, (b, m), dtype=np.uint8)
    ksel = np.asarray([0, 3, 7], np.int32)
    idx = np.asarray([0, 5, 1021], np.int32)
    packed, n_valid = psk8_relabel_pack_batch(
        jnp.asarray(sec), jnp.asarray(ksel), jnp.asarray(idx)
    )
    packed, n_valid = np.asarray(packed), np.asarray(n_valid)
    for i in range(b):
        st = ((sec[i].astype(np.int32) + (8 - ksel[i])) % 8).astype(np.uint8)
        bits = np.asarray(_psk8_gray_bits(jnp.asarray(st)))
        want, nv = pack_bits_from(jnp.asarray(bits), jnp.int32(3 * idx[i]))
        want = np.asarray(want)[: int(nv)]
        off = 3 * (int(idx[i]) // 8)
        assert n_valid[i] == int(nv) + off
        got = packed[i][off : n_valid[i]]
        # pack_bits_from's final partial byte may differ (it packs the tail
        # bits into LOW positions; the banded stream keeps streaming), so
        # compare the full-byte overlap.
        L = min(len(got), len(want)) - 1
        assert L > 100
        assert np.array_equal(got[:L], want[:L])


def test_cfo_retry_off_rejects_rotated(rng):
    """cfo_retry=False must not silently decode a rotated capture."""
    m = 256 * 128
    frame = pack_frame("r.bin", b"z" * 64, 0, 1, 64, crc32(b"z" * 64))
    sec = _sectors_from_bytes(frame, 50, 2, m, rng)[None, :]
    assert not _tail(sec, cfo_retry=False)[0][1]
    assert not ref.psk8_sync(sec[0], n_rotations=1)[1]
    assert _tail(sec, cfo_retry=True)[0][1]


def test_relabel_pack_batch_matches_reference(rng):
    """The banded relabel+pack einsum equals the plain relabel + Gray bits +
    packbits, shifted by the whole bytes the mod-8 contract leaves to the
    parser: stream byte 3*(idx//8) onward == reference bytes from symbol
    idx."""
    b, r = 2, 256
    m = r * 128
    sec = rng.integers(0, 8, (b, m), dtype=np.uint8)
    ksel = np.asarray([3, 6], np.int32)
    idx = np.asarray([5, 1021], np.int32)
    got, n_valid = psk8_relabel_pack_batch(
        jnp.asarray(sec), jnp.asarray(ksel), jnp.asarray(idx % 8)
    )
    got, n_valid = np.asarray(got), np.asarray(n_valid)
    for i in range(b):
        want = ref.pack_from(ref.psk8_gray_bits(sec[i].astype(np.int64) - ksel[i]), 3 * int(idx[i] % 8))
        L = min(int(n_valid[i]), len(want)) - 1
        assert L > 10000
        assert bytes(got[i][:L]) == want[:L], f"capture {i}"
