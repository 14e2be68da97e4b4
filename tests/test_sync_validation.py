"""Validated magic sync: a false 16-bit pattern occurrence must not steal
the sync (and with it the rotation relabeling) from the true magic."""

import numpy as np
import pytest

import jax.numpy as jnp

from audio_modem_radio.framing import MAGIC, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from audio_modem_radio.ops.common import (
    _GRAY_HI,
    _GRAY_LO,
    dibit_sync_and_pack_rotations,
)


def _dibits_from_bytes(raw: bytes):
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    return bits[0::2].copy(), bits[1::2].copy()


def _rotate_stream(hi, lo, k):
    """Relabel every Gray dibit by +k sectors (what a CFO residual does)."""
    sector = (2 * hi + (hi ^ lo)).astype(np.int64)
    s2 = (sector + k) % 4
    return (
        np.asarray(_GRAY_HI, np.uint8)[s2],
        np.asarray(_GRAY_LO, np.uint8)[s2],
    )


def _build_stream(k_true: int, with_decoy: bool, n_dib=4096, seed=0):
    """Random dibit stream with the full 32-bit magic at a known position,
    rotated by k_true; optionally a DECOY 16-bit pattern earlier whose
    following bits are anti-magic."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2, n_dib, dtype=np.uint8)
    lo = rng.integers(0, 2, n_dib, dtype=np.uint8)
    pat1 = np.asarray([int(c) for c in MAGIC_BIT_PATTERN], np.uint8)
    pat2 = np.asarray([int(c) for c in MAGIC_BIT_PATTERN2], np.uint8)
    full = np.concatenate([pat1, pat2])

    true_pos = 2000  # dibit index (even bit offset)
    hi[true_pos : true_pos + 16] = full[0::2]
    lo[true_pos : true_pos + 16] = full[1::2]

    # Kill accidental 16-bit magics elsewhere under every rotation: the
    # stream is random, so just strike any occurrence outside the plant.
    if with_decoy:
        decoy = np.concatenate([pat1, 1 - pat2])  # valid 16, anti-valid next
        hi[500 : 500 + 16] = decoy[0::2]
        lo[500 : 500 + 16] = decoy[1::2]

    hi_r, lo_r = _rotate_stream(hi, lo, k_true)
    return hi_r, lo_r, true_pos


@pytest.mark.parametrize("k_true", [1, 2, 3])
def test_decoy_does_not_steal_rotated_sync(k_true, rng):
    """A k=0-looking decoy before a rotated true magic: validation must
    reject the decoy so the true rotation wins and the stream relabels
    correctly (old behavior: decoy wins, whole stream scrambled)."""
    hi, lo, true_pos = _build_stream(k_true, with_decoy=True)
    packed, n_valid, found = dibit_sync_and_pack_rotations(
        jnp.asarray(hi), jnp.asarray(lo), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    )
    assert bool(found)
    out = np.asarray(packed)[: int(n_valid)].tobytes()
    assert out.startswith(MAGIC), out[:8]


def test_clean_unrotated_with_decoy_still_syncs(rng):
    """k=0 capture with a decoy: the decoy is rejected, the true magic at
    the later position is taken."""
    hi, lo, true_pos = _build_stream(0, with_decoy=True)
    packed, n_valid, found = dibit_sync_and_pack_rotations(
        jnp.asarray(hi), jnp.asarray(lo), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    )
    assert bool(found)
    assert np.asarray(packed)[: int(n_valid)].tobytes().startswith(MAGIC)


@pytest.mark.parametrize("k_true", [0, 2])
def test_batched_tail_validates(k_true, rng):
    """The batched dibit tail's tolerant second stage rejects the decoy too:
    its bytes equal the plain reference's and start at the TRUE magic."""
    import plain_reference as ref
    from audio_modem_radio.parallel.batch import _dibit_sync_tail

    hi, lo, true_pos = _build_stream(k_true, with_decoy=True, n_dib=256 * 128, seed=3)
    packed, n_valid, found = _dibit_sync_tail(
        jnp.asarray(hi[None]), jnp.asarray(lo[None]), True
    )
    raw = np.asarray(packed[0])[: int(n_valid[0])].tobytes()
    want, want_found = ref.dibit_sync(hi, lo)
    assert bool(found[0]) and want_found and raw == want
    assert raw.startswith(MAGIC)
    assert len(raw) == (2 * (len(hi) - true_pos)) // 8


def test_pattern_find_on_stream_shorter_than_pattern():
    """A bit stream shorter than the sync pattern (a truncated DSSS capture
    after 16x despreading hit this as a negative-shape crash) must report
    not-found, both with and without the validation window."""
    import jax.numpy as jnp

    from audio_modem_radio.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio.ops.common import (
        find_bit_pattern,
        find_bit_pattern_validated,
    )

    short = jnp.asarray([1, 0, 1], dtype=jnp.uint8)
    s, found = find_bit_pattern(short, MAGIC_BIT_PATTERN)
    assert int(s) == 0 and not bool(found)
    # Long enough for the bare pattern but not pattern+validation window:
    # degrades to the plain finder instead of crashing.
    bits = jnp.asarray([int(c) for c in MAGIC_BIT_PATTERN] + [0], dtype=jnp.uint8)
    s, found = find_bit_pattern_validated(
        bits, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    )
    assert bool(found) and int(s) == 0


def test_short_stream_validates_against_pattern2_prefix():
    """When the capture fits the pattern plus only PART of the validation
    window, the finder must validate against the truncated pattern2 prefix
    (tol scaled down) rather than silently accept unvalidated matches."""
    import jax.numpy as jnp

    from audio_modem_radio.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio.ops.common import find_bit_pattern_validated

    prefix = [int(c) for c in MAGIC_BIT_PATTERN2[:6]]
    good = jnp.asarray([int(c) for c in MAGIC_BIT_PATTERN] + prefix, jnp.uint8)
    s, found = find_bit_pattern_validated(good, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    assert bool(found) and int(s) == 0
    # All six following bits flipped: scaled tol = ceil(3*6/16) = 2 < 6
    # mismatches, so the match must be REJECTED (pre-fix it was accepted).
    bad = jnp.asarray(
        [int(c) for c in MAGIC_BIT_PATTERN] + [1 - b for b in prefix], jnp.uint8
    )
    s, found = find_bit_pattern_validated(bad, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    assert not bool(found)
