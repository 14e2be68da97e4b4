"""Real direct-sequence spread spectrum (DSSS) over the DBPSK physical layer.

The reference's "DSSS" is a bare DBPSK alias — no spreading happens
(/root/reference/modem.py:380-383), yet the mode name promises exactly the
one thing an acoustic modem wants from DSSS: decoding BELOW the noise floor.
This module implements it: each differentially-encoded data bit is spread
over a 16-chip PN sequence at the mode's chip rate, and the receiver sums
the per-chip projection phasors coherently per bit before the differential —
a ~12 dB processing gain, so frames recover at negative SNR where plain
DBPSK (the alias) is long dead. modem.py keeps the alias behind
``modem.dsss_compat_alias`` with a probe-gated receive fallback, the same
deviation pattern as real OFDM/8PSK (COMPAT.md).

Array-first structure, built on the shared PSK machinery (ops/psk.py):

* The chip front end IS the DBPSK front end: blocked projection matmuls at
  chip rate (:func:`psk.psk_symbol_streams` — raw phasors, because the
  despread sum must happen BEFORE the differential; chip differentials only
  carry data at bit boundaries, which would forfeit the gain).
* Despreading is one (n_bits, 16) @ (16,) matmul per chip alignment; all 16
  alignment hypotheses are scored by the 4-fold differential coherence (the
  despread bits are BPSK-valued) and the winner selected in-trace.
* Bit sync + byte pack reuse the DBPSK rotation-sync tail verbatim
  (ops/common.py bit_sync_and_pack_rotations).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .common import bytes_to_bits, matmul_precision, pack_bits_from
from .psk import (
    BPSK_PREAMBLE_BITS,
    _bucket_symbols,
    _samples_per_symbol,
    _synthesize,
    psk_symbol_streams,
)

# 16-chip PN sequence: the K=4 m-sequence (x^4 + x + 1, 15 chips, ideal
# two-valued periodic autocorrelation) with its final chip repeated to a
# power-of-two length. 0/1 chips; ±1 signs derived below.
SPREAD = 16
_PN_BITS = np.array([1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0], np.uint8)
_PN_SIGN = (1.0 - 2.0 * _PN_BITS).astype(np.float32)  # bit 1 -> -1 (phase π)


def dsss_real_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DSSS-DBPSK: differential data bits spread over the 16-chip PN.

    ``baud`` is the CHIP rate (the registry's symbol_rate, like every PSK
    mode here); the data rate is ``baud / 16`` bits/s. Chip phase =
    diff_bit XOR pn_chip, synthesized by the shared quarter-turn matmul
    (values 0/2 — BPSK antipodal)."""
    bits = np.concatenate(
        [np.asarray(BPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    ).astype(np.int64)
    diff = np.cumsum(bits) % 2  # DBPSK convention: 1 = invert phase
    chips = diff[:, None] ^ _PN_BITS[None, :].astype(np.int64)  # (n_bits, 16)
    phase_qt = (chips.reshape(-1) * 2).astype(np.int32)
    spchip = _samples_per_symbol(samp_rate, baud)
    n_chips = len(phase_qt)
    phase_qt = np.pad(phase_qt, (0, _bucket_symbols(n_chips) - n_chips))
    out = _synthesize(jnp.asarray(phase_qt), spchip, float(carrier), int(samp_rate))
    return np.asarray(out)[: n_chips * spchip]


def _despread_all(re_f: jnp.ndarray, im_f: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Chip phasors -> (16, n_bits) despread bit phasors, one row per chip
    alignment hypothesis. Each row is one reshape + one (n_bits, 16) @ (16,)
    matmul — the coherent sum that realizes the processing gain."""
    n = re_f.shape[0]
    n_bits = n // SPREAD
    # Zero-pad so every alignment despreads the FULL chip stream: a uniform
    # (n - 15)//16 group count dropped the final bit at a=0 — the frame's
    # last CRC byte (found by the clean round-trip test). Pad chips are
    # zero phasors, so a nonzero alignment's trailing group only appends
    # one garbage bit past the capture, which the parser ignores.
    re_p = jnp.concatenate([re_f, jnp.zeros((SPREAD,), re_f.dtype)])
    im_p = jnp.concatenate([im_f, jnp.zeros((SPREAD,), im_f.dtype)])
    pn = jnp.asarray(_PN_SIGN)
    rows_re, rows_im = [], []
    for a in range(SPREAD):
        rows_re.append(
            jnp.matmul(re_p[a : a + n_bits * SPREAD].reshape(n_bits, SPREAD), pn, precision=matmul_precision())
        )
        rows_im.append(
            jnp.matmul(im_p[a : a + n_bits * SPREAD].reshape(n_bits, SPREAD), pn, precision=matmul_precision())
        )
    return jnp.stack(rows_re), jnp.stack(rows_im)


def _dsss_best_raw(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Chip phasors -> best-alignment despread RAW bit phasors.

    Returns ``(b_re[a], b_im[a], a)`` — the coherent 16-chip sums BEFORE the
    differential, at the chip alignment selected by 4-fold coherence of the
    bit differentials. Shared by the differential core (below) and the
    round-5 tracked receiver, which needs raw phasors (its z² carrier track
    replaces the one-noisy-symbol differential reference)."""
    from .psk import _coherence_score

    re_f, im_f, _score = psk_symbol_streams(
        samples, baud, carrier, sample_rate, n_psk=2
    )
    b_re, b_im = _despread_all(re_f, im_f)  # (16, n_bits)
    d_re = b_re[:, 1:] * b_re[:, :-1] + b_im[:, 1:] * b_im[:, :-1]
    d_im = b_im[:, 1:] * b_re[:, :-1] - b_re[:, 1:] * b_im[:, :-1]
    a = jnp.argmax(_coherence_score(d_re, d_im, axis=1))
    return b_re[a], b_im[a], a


def _dsss_best_diff(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shared DSSS receive core: chip phasors -> best-alignment despread bit
    DIFFERENTIALS, blind-derotated. Returns ``(dr, di)``; the data rides the
    real axis (bit = dr < 0). Used by the sync tail, the no-sync rescue, and
    the soft-bit producer — three consumers of the identical front end."""
    from .psk import derotate, estimate_common_rotation

    br, bi, _a = _dsss_best_raw(samples, baud, carrier, sample_rate)
    dr = br[1:] * br[:-1] + bi[1:] * bi[:-1]
    di = bi[1:] * br[:-1] - br[1:] * bi[:-1]
    return derotate(dr, di, estimate_common_rotation(dr, di))


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "pattern", "pattern2")
)
def _dsss_bits_cfo(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    pattern: str, pattern2: str = "",
):
    """Despread + sync + pack: the full DSSS receive tail.

    Chip alignment is selected by the 4-fold coherence of the despread bit
    DIFFERENTIALS (despread bits are BPSK-valued, so the DQPSK/DBPSK timing
    argument applies unchanged; a misaligned despread mixes two diff bits
    under a rotated PN and its coherence collapses). The byte tail is the
    DBPSK rotation sync verbatim — a CFO-induced common rotation survives
    the coherent chip sum untouched and cancels in the bit differential.
    """
    from .common import bit_sync_and_pack_rotations

    dr, di = _dsss_best_diff(samples, baud, carrier, sample_rate)
    bits_re = (dr < 0).astype(jnp.uint8)
    bits_im = (di < 0).astype(jnp.uint8)
    return bit_sync_and_pack_rotations(bits_re, bits_im, pattern, pattern2)


def dsss_real_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """DSSS receive chain: chips -> despread bits -> magic-aligned bytes."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _dsss_bits_cfo(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2,
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "sample_rate", "pattern", "pattern2", "window"),
)
def _dsss_bytes_tracked(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    pattern: str, pattern2: str = "", window: int = 128,
):
    """Coherent-tracked DSSS demod to bytes: shared chip front end + despread
    (raw phasors), z² V&V carrier track on the despread BIT stream, absolute
    antipodal decisions, XOR differential decode, single-pattern sync.

    The despread stream is DBPSK (post-despread per-bit Es/N0 at the −9 dB
    full-band operating point is ~13 dB — the 16-chip coherent sum is the
    ~22 dB per-bit processing gain), so ops/psk's z² tracker applies
    verbatim; its residual antipodal ambiguity cancels in the XOR delta."""
    from .common import find_bit_pattern_validated, pack_bits_from
    from .psk import bpsk_tracked_bits

    br, bi, _a = _dsss_best_raw(samples, baud, carrier, sample_rate)
    bits = bpsk_tracked_bits(br, bi, window)
    start, found = find_bit_pattern_validated(bits, pattern, pattern2)
    packed, n_valid = pack_bits_from(bits, start)
    return packed, n_valid, found


def dsss_tracked_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0,
    samp_rate: int = 96000, window: int = 128,
) -> bytes:
    """Coherent-tracked DSSS receive — recovers the DBPSK noisy-reference
    penalty on the despread stream (~1 dB at the waterfall,
    benchmarks/dsss_bound.py) at ~zero extra cost over the shared front end
    (the tracker runs at the bit rate, baud/16). The mode ladder escalates
    here when the differential pass finds no complete capture
    (modem._dsss_mode_demodulate)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _dsss_bytes_tracked(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.lru_cache(maxsize=1)
def _despread_band() -> np.ndarray:
    """(2*SPREAD-1, SPREAD) banded despread template: column ``a`` holds the
    PN signs shifted down by ``a``, so window j (chips 16j..16j+30) @ band
    yields the despread phasor of bit j at every chip alignment at once."""
    T = np.zeros((2 * SPREAD - 1, SPREAD), np.float32)
    for a in range(SPREAD):
        T[a : a + SPREAD, a] = _PN_SIGN
    return T


def _despread_all_batch(x: jnp.ndarray) -> jnp.ndarray:
    """(B, n) chip phasors -> (B, 16, n_bits) despread rows, one per chip
    alignment. ONE overlapped-window matmul against the banded PN template —
    the single-capture path's 16 strided reshapes would copy the whole
    batch 16 times. Bit-group semantics match :func:`_despread_all`:
    alignment ``a``'s group ``j`` sums chips [16j+a, 16j+a+16) with chips
    past the capture reading zero."""
    b, n = x.shape
    nb = n // SPREAD
    if nb == 0:
        # Fewer chips than one spread group (truncated capture): no
        # despreadable bits. Return empty rows so the batch path degrades
        # to not-found, exactly like the single-capture ``_despread_all``
        # (the concat below would otherwise build mismatched shapes).
        return jnp.zeros((b, SPREAD, 0), x.dtype)
    rows = x[:, : nb * SPREAD].reshape(b, nb, SPREAD)
    # Next-row heads (15 chips); the final row's head is the capture's
    # remainder chips (n may exceed nb*16) zero-padded — exactly the
    # single-capture path's zero-pad semantics.
    tail = jnp.zeros((b, SPREAD - 1), x.dtype)
    rem = n - nb * SPREAD
    if rem > 0:
        tail = tail.at[:, :rem].set(x[:, nb * SPREAD :])
    nxt = jnp.concatenate([rows[:, 1:, : SPREAD - 1], tail[:, None, :]], axis=1)
    wins = jnp.concatenate([rows, nxt], axis=2)  # (B, nb, 31)
    out = jnp.matmul(wins, jnp.asarray(_despread_band()), precision=matmul_precision())  # (B, nb, 16)
    return out.transpose(0, 2, 1)  # (B, 16, nb)


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "pattern", "pattern2")
)
def dsss_bits_cfo_batch(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    pattern: str, pattern2: str = "",
):
    """Batched DSSS receive: (B, N) captures (or pre-shaped (B, r, 128*spchip)
    rows) -> (packed (B, max_bytes), n_valid (B,), found (B,)).

    The chip front end is the shared blocked batch machinery at raw phasors
    (:func:`ops.psk.psk_raw_streams_batch` — pass-1 timing scores + ONE
    einsum at each capture's winning offset); despreading is one banded
    matmul over 16x-reduced data; alignment select / derotation / sync run
    per capture on the bit-rate stream (nowhere near kernel-worthy at
    baud/16 bits/s). Replaces the vmapped single-capture path and its
    per-capture pass-1 window gathers and 16 strided despread reshapes.
    """
    from .common import bit_sync_and_pack_rotations
    from .psk import (
        _coherence_score,
        derotate,
        estimate_common_rotation,
        psk_raw_streams_batch,
    )

    re_f, im_f = psk_raw_streams_batch(samples, baud, carrier, sample_rate, n_psk=2)
    b_re = _despread_all_batch(re_f)  # (B, 16, nb)
    b_im = _despread_all_batch(im_f)
    d_re = b_re[:, :, 1:] * b_re[:, :, :-1] + b_im[:, :, 1:] * b_im[:, :, :-1]
    d_im = b_im[:, :, 1:] * b_re[:, :, :-1] - b_re[:, :, 1:] * b_im[:, :, :-1]
    a = jnp.argmax(_coherence_score(d_re, d_im, axis=2), axis=1)  # (B,)
    dr = jnp.take_along_axis(d_re, a[:, None, None], axis=1)[:, 0]
    di = jnp.take_along_axis(d_im, a[:, None, None], axis=1)[:, 0]
    dr, di = derotate(dr, di, estimate_common_rotation(dr, di))
    bits_re = (dr < 0).astype(jnp.uint8)
    bits_im = (di < 0).astype(jnp.uint8)
    return jax.vmap(
        lambda br, bi: bit_sync_and_pack_rotations(br, bi, pattern, pattern2)
    )(bits_re, bits_im)


@functools.partial(jax.jit, static_argnames=("baud", "carrier", "sample_rate"))
def _dsss_bytes_nosync(samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int):
    """DSSS no-sync rescue front end: the best-alignment despread bit
    streams (re and im signs, derotated) packed from offset 0 — the DBPSK
    analog for the header-tolerant rescue sweep."""
    dr, di = _dsss_best_diff(samples, baud, carrier, sample_rate)
    out = []
    for comp in ((dr < 0), (di < 0)):
        out.append(pack_bits_from(comp.astype(jnp.uint8), jnp.int32(0)))
    return out


def dsss_nosync_streams(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int
) -> list:
    """Host wrapper for :func:`_dsss_bytes_nosync`: list of byte streams."""
    pairs = _dsss_bytes_nosync(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(samp_rate)
    )
    return [bytes(np.asarray(p)[: int(n)]) for p, n in pairs]


_dsss_soft_core = jax.jit(
    _dsss_best_diff, static_argnames=("baud", "carrier", "sample_rate")
)


def dsss_soft_bits(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int
) -> np.ndarray:
    """Soft bit stream in [0, 1] for the soft-decision FEC escalations.

    The despread bit differentials are BPSK-valued (bit = sign of the real
    part after derotation), so each bit's soft value is a linear scaling of
    the COHERENT 16-chip sum — the soft stream carries the full ~12 dB
    processing gain, making this the family where the soft Viterbi's ~2 dB
    matters most (DSSS is the designated below-the-noise-floor mode).
    Same [0,1] convention as :func:`ops.psk.psk_soft_bits` (n_psk=2: the
    residual inversion ambiguity is the consumer's two-hypothesis sweep).
    """
    dr, di = _dsss_soft_core(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(samp_rate)
    )
    dr, di = np.asarray(dr), np.asarray(di)
    scale = np.mean(np.abs(dr) + np.abs(di)) + 1e-9
    return np.clip(0.5 - dr / scale, 0.0, 1.0).astype(np.float32)
