"""Unit tests for the shared DSP primitives (sync, packing, spectra)."""

import numpy as np
import pytest

import jax.numpy as jnp

from audio_modem_radio.ops.common import (
    analytic_bandpass,
    bit_sync_and_pack,
    bits_to_bytes,
    bytes_to_bits,
    dibit_sync_and_pack,
    find_bit_pattern,
    pack_bits_from,
)

MAGIC = "0100011001000010"  # first 16 bits of b'FBPC'


def test_bytes_bits_roundtrip(rng):
    data = rng.integers(0, 256, 257, dtype=np.uint8).tobytes()
    assert bits_to_bytes(bytes_to_bits(data)) == data


def test_find_bit_pattern_positions():
    pat = np.asarray([int(c) for c in MAGIC], np.uint8)
    for pos in (0, 1, 7, 100, 1000):
        bits = np.zeros(2048, np.uint8)
        bits[pos : pos + 16] = pat
        idx, found = find_bit_pattern(jnp.asarray(bits), MAGIC)
        assert bool(found) and int(idx) == pos


def test_find_bit_pattern_absent():
    idx, found = find_bit_pattern(jnp.zeros(512, jnp.uint8), MAGIC)
    assert not bool(found) and int(idx) == 0


def test_pack_bits_from_offsets(rng):
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    bits = bytes_to_bits(data)
    for start in (0, 8, 24):
        packed, n_valid = pack_bits_from(jnp.asarray(bits), jnp.int32(start))
        out = bytes(np.asarray(packed)[: int(n_valid)])
        assert out == data[start // 8 :]


def test_bit_sync_and_pack_end_to_end(rng):
    payload = b"FBPC" + rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    bits = np.concatenate([rng.integers(0, 2, 13, dtype=np.uint8) * 0, bytes_to_bits(payload)])
    packed, n_valid, found = bit_sync_and_pack(jnp.asarray(bits), MAGIC)
    assert bool(found)
    out = bytes(np.asarray(packed)[: int(n_valid)])
    assert out.startswith(payload)


@pytest.mark.parametrize("bit_offset", [0, 1, 2, 3, 16, 17])
def test_dibit_sync_both_parities(rng, bit_offset):
    """The dual-stream sync must find the magic at even AND odd bit offsets
    (odd = a bit slip splits every dibit across byte boundaries)."""
    payload = b"FBPC" + rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    stream = np.concatenate([np.zeros(bit_offset, np.uint8), bytes_to_bits(payload), np.zeros(7, np.uint8)])
    if len(stream) % 2:
        stream = np.concatenate([stream, np.zeros(1, np.uint8)])
    hi, lo = stream[0::2], stream[1::2]
    packed, n_valid, found = dibit_sync_and_pack(jnp.asarray(hi), jnp.asarray(lo), MAGIC)
    assert bool(found)
    out = bytes(np.asarray(packed)[: int(n_valid)])
    assert out.startswith(payload)


def test_dibit_sync_not_found():
    hi = jnp.zeros(256, jnp.uint8)
    lo = jnp.zeros(256, jnp.uint8)
    packed, n_valid, found = dibit_sync_and_pack(hi, lo, MAGIC)
    assert not bool(found)
    assert int(n_valid) == 64  # fallback packs from offset 0


def test_analytic_bandpass_extracts_tone():
    sr = 96000
    t = np.arange(10_000) / sr  # non-power-of-2 length (internal FFT pad)
    x = np.sin(2 * np.pi * 3000 * t) + 0.5 * np.sin(2 * np.pi * 20000 * t)
    z = np.asarray(analytic_bandpass(jnp.asarray(x, jnp.float32), 2000, 4000, sr))
    mid = slice(1000, 9000)  # away from edge transients
    # Envelope ~1 (the 3 kHz component), 20 kHz component rejected.
    assert np.abs(np.abs(z[mid]).mean() - 1.0) < 0.05
    inst = np.angle(z[1:] * np.conj(z[:-1])) * sr / (2 * np.pi)
    assert abs(np.median(inst[mid]) - 3000) < 20


@pytest.mark.parametrize("k", [0, 3])
def test_rotation_sync_matches_plain_reference(k, rng):
    """``dibit_sync_and_pack_rotations`` agrees with the plain numpy sync on
    random lanes with the magic, as received under rotation ``k``, planted
    at an odd bit parity, and on lanes with none."""
    import jax.numpy as jnp

    import plain_reference as ref
    from audio_modem_radio.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio.ops.common import dibit_sync_and_pack_rotations

    m = 256 * 128
    hi = rng.integers(0, 2, m).astype(np.uint8)
    lo = rng.integers(0, 2, m).astype(np.uint8)
    bits = ref.interleave(hi, lo)
    p = ref.rotate_pattern(ref.bits_of(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2), k)
    bits[7001 : 7001 + len(p)] = p  # odd parity: starts in a lo lane
    hi, lo = bits[0::2], bits[1::2]
    for h, l in ((hi, lo), (np.zeros_like(hi), np.zeros_like(lo))):
        packed, n_valid, found = dibit_sync_and_pack_rotations(
            jnp.asarray(h), jnp.asarray(l), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
        )
        want, want_found = ref.dibit_sync(h, l)
        assert bool(found) == want_found
        assert bytes(np.asarray(packed)[: int(n_valid)]) == want
    assert want_found is False and ref.dibit_sync(hi, lo)[1]
