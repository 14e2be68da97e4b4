"""Differential BPSK / QPSK: array-native modulation and demodulation.

Wire-compatible with the reference's DBPSK/DQPSK signal definitions
(/root/reference/modem.py:28-266): MSB-first bits, the same preambles
(``[1,0]*40`` for DBPSK, ``[0,0]*30+[1,1]*10`` dibits for DQPSK), differential
phase encoding (Gray map 00->0, 01->+90°, 11->180°, 10->-90° for DQPSK), sine
carrier with a 10% linear ramp envelope per symbol, and magic-pattern byte
alignment on receive.

Array-first architecture (not a translation of the reference's loops):

* **Modulation** — per-symbol phases are exact integer *quarter-turns*
  accumulated on the host (no float drift over millions of symbols); the
  waveform is a single ``(n_symbols, 2) @ (2, samples_per_symbol)`` matmul of
  ``(cos φ, sin φ)`` rows against precomputed carrier basis functions, instead
  of a Python loop synthesizing each symbol.
* **Demodulation** — the whole receive front end (the reference's bandpass
  filtfilt -> mix -> lowpass filtfilt -> stride-sample chain) collapses into a
  single real matmul: overlapping 2-symbol sample frames times a dual-basis
  template matrix that least-squares-projects each window onto its symbol
  subspace, for *all timing-offset hypotheses at once*; differential
  detection, offset selection, and Gray de-mapping are vectorized elementwise
  ops. See ``_offset_templates`` for why this is exact at any carrier/baud
  ratio where the reference receiver is not.

The reference samples a *single* baseband point per symbol; correlating over
the full symbol window is the matched filter for this waveform, so noise
performance is at least as good at identical configurations.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .common import (
    bit_sync_and_pack,
    bytes_to_bits,
    find_bit_pattern,
    frame_signal,
    matmul_precision,
    pack_bits_from,
)

# Exact unit-circle table for quarter-turn phases: cos/sin of k*pi/2.
_QT_COS = np.array([1.0, 0.0, -1.0, 0.0], dtype=np.float64)
_QT_SIN = np.array([0.0, 1.0, 0.0, -1.0], dtype=np.float64)

# DQPSK Gray map: dibit (hi, lo) -> phase delta in quarter turns.
_DIBIT_TO_QT = {(0, 0): 0, (0, 1): 1, (1, 1): 2, (1, 0): 3}
# Inverse map used on receive: quantized quarter-turn -> (hi, lo).
_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dtype=np.uint8)

BPSK_PREAMBLE_BITS = [1, 0] * 40
QPSK_PREAMBLE_BITS = [0, 0] * 30 + [1, 1] * 10


def _samples_per_symbol(sample_rate: int, baud: float) -> int:
    # int() truncation, matching the reference (modem.py:36) so symbol
    # boundaries line up sample-exactly across implementations.
    return int(sample_rate / baud)


def _bucket_symbols(n: int) -> int:
    """Round a symbol count up to a coarse bucket so the jitted synthesizers
    compile once per bucket instead of once per file length (device compiles
    are expensive); callers slice the waveform back to the exact length."""
    b = 256
    while b < n:
        b <<= 1
    return b


@functools.lru_cache(maxsize=64)
def _carrier_basis(spsym: int, carrier: float, sample_rate: int) -> np.ndarray:
    """(2, spsym) rows = (sin, cos) of the carrier over one symbol, ramped.

    The 10% linear ramp envelope matches the reference's anti-click windowing
    (modem.py:58-63).
    """
    t = np.arange(spsym, dtype=np.float64) / sample_rate
    env = np.ones(spsym)
    ramp = int(spsym * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    w = 2 * np.pi * carrier * t
    return np.stack([np.sin(w) * env, np.cos(w) * env]).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("spsym", "carrier", "sample_rate"))
def _synthesize(phase_qt: jnp.ndarray, spsym: int, carrier: float, sample_rate: int) -> jnp.ndarray:
    """Quarter-turn phase indices (n_sym,) -> waveform (n_sym*spsym,).

    sin(w + φ) = sin(w)cos(φ) + cos(w)sin(φ): a (n_sym, 2) @ (2, spsym) matmul.
    """
    basis = jnp.asarray(_carrier_basis(spsym, carrier, sample_rate))
    cs = jnp.stack(
        [jnp.asarray(_QT_COS, jnp.float32)[phase_qt], jnp.asarray(_QT_SIN, jnp.float32)[phase_qt]],
        axis=1,
    )
    return jnp.matmul(cs, basis, precision=matmul_precision()).reshape(-1)


def bpsk_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DBPSK: 1 = invert phase, 0 = keep phase; ``[1,0]*40`` preamble."""
    bits = np.concatenate(
        [np.asarray(BPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    ).astype(np.int64)
    # Differential: phase after bit k is (number of ones so far) half turns.
    half_turns = np.cumsum(bits) % 2
    phase_qt = (half_turns * 2).astype(np.int32)  # 0 or 2 quarter-turns
    spsym = _samples_per_symbol(samp_rate, baud)
    n_sym = len(phase_qt)
    phase_qt = np.pad(phase_qt, (0, _bucket_symbols(n_sym) - n_sym))
    out = _synthesize(jnp.asarray(phase_qt), spsym, float(carrier), int(samp_rate))
    return np.asarray(out)[: n_sym * spsym]


def qpsk_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DQPSK with Gray-coded phase deltas and the reference preamble."""
    bits = np.concatenate(
        [np.asarray(QPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    )
    if len(bits) % 2:
        bits = np.concatenate([bits, np.zeros(1, np.uint8)])
    hi, lo = bits[0::2].astype(np.int64), bits[1::2].astype(np.int64)
    # Gray map as arithmetic on (hi, lo): 00->0, 01->1, 11->2, 10->3 quarter turns.
    deltas = hi * 3 + lo * (1 - 2 * hi)
    phase_qt = (np.cumsum(deltas) % 4).astype(np.int32)
    spsym = _samples_per_symbol(samp_rate, baud)
    n_sym = len(phase_qt)
    phase_qt = np.pad(phase_qt, (0, _bucket_symbols(n_sym) - n_sym))
    out = _synthesize(jnp.asarray(phase_qt), spsym, float(carrier), int(samp_rate))
    return np.asarray(out)[: n_sym * spsym]


# --- demodulation -------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _offset_templates(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(2*spsym, 2*n_offsets) real templates: per-offset dual basis of the symbol subspace.

    Every transmitted symbol is exactly ``cos(φ)·b1 + sin(φ)·b2`` with
    ``b1 = sin(wt)·env`` and ``b2 = cos(wt)·env`` (the modulator restarts the
    carrier at each symbol, like the reference, modem.py:37,54). Recovering
    ``(cos φ, sin φ)`` is therefore a least-squares projection onto that 2-D
    subspace: columns ``2i`` / ``2i+1`` hold the Gram-inverse dual basis
    ``G⁻¹·[b1 b2]ᵀ`` for the window starting ``i*spsym//n_offsets`` samples
    into a 2-symbol frame. This is exact for *any* carrier/baud ratio — unlike
    plain quadrature correlation, which breaks when the symbol holds fewer
    than ~1 carrier cycle (and unlike the reference's global-LO mixing, which
    adds a spurious ``2π·frac(carrier/baud)`` rotation to every differential
    angle whenever carrier/baud is not an integer — the defect behind its own
    logged QPSK self-decode failure). A window offset only rotates the
    recovered phasor by a constant, which differential detection cancels.
    """
    t = np.arange(2 * spsym, dtype=np.float64)
    w = 2 * np.pi * carrier * t / sample_rate
    env = np.ones(spsym)
    ramp = int(spsym * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    T = np.zeros((2 * spsym, 2 * n_offsets), dtype=np.float64)
    for i in range(n_offsets):
        o = i * spsym // n_offsets
        B = np.stack([np.sin(w[o : o + spsym]) * env, np.cos(w[o : o + spsym]) * env], axis=1)
        G = B.T @ B + 1e-9 * np.eye(2)
        T[o : o + spsym, 2 * i : 2 * i + 2] = B @ np.linalg.inv(G)  # (spsym, 2)
    return T.astype(np.float32)


# Symbols per row in the blocked fast path (row width = _BLOCK_SYM * spsym
# lanes, always a multiple of 128 — zero layout padding).
_BLOCK_SYM = 128
# Blocked path applies when spsym <= this (template stack stays small and the
# (n_frames, spsym) layout padding it avoids is >= 4x there).
_BLOCK_MAX_SPSYM = 32


@functools.lru_cache(maxsize=64)
def _blocked_templates(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, ROW+OV, 2*_BLOCK_SYM) block-diagonal projection matrices.

    Row chunk layout: 128 consecutive symbols live in one (ROW,) lane row;
    symbol s's 2-symbol correlation window occupies rows [s*spsym,
    s*spsym+2*spsym) of the matrix; output columns are [re x 128 | im x 128].
    The overlap tail (OV lanes from the next row chunk) lets the last symbol's
    window extend past the chunk.
    """
    T = _offset_templates(spsym, carrier, sample_rate, n_offsets)  # (2*spsym, 2K)
    row = _BLOCK_SYM * spsym
    ov = 128 * int(np.ceil(2 * spsym / 128))
    W = np.zeros((n_offsets, row + ov, 2 * _BLOCK_SYM), dtype=np.float32)
    for i in range(n_offsets):
        for s in range(_BLOCK_SYM):
            W[i, s * spsym : s * spsym + 2 * spsym, s] = T[:, 2 * i]
            W[i, s * spsym : s * spsym + 2 * spsym, _BLOCK_SYM + s] = T[:, 2 * i + 1]
    return W


def psk_demod_streams(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Differential phasor streams (d_re, d_im, best_offset_score).

    The shared demod core for DBPSK and DQPSK. Performance architecture:

    * Symbol index on the fast (last) axis everywhere: no
      (n_frames, spsym) intermediate with a small minor dim.
    * Blocked projection: 128 consecutive symbols per (128*spsym,)-lane row;
      the least-squares symbol projection for the whole row is ONE matmul
      against a block-diagonal template (ROW+OV, 256) — one dense matmul
      instead of many small ones.
    * No complex dtype, no atan2: the differential product is two real
      multiply-adds; Gray decisions are sign/compare only.
    * Two passes: pass 1 scores all timing offsets on three small sample
      windows; pass 2 projects the full signal at only the winning offset
      (materializing all 8 hypotheses costs 16x the input in HBM writes).
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    x_flat, n_frames = _psk_frame_setup(samples, spsym)
    best, score = _psk_pass1(
        x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk
    )

    # --- pass 2: full-signal projection at the winning offset ---------------
    re_f, im_f = _psk_project_xla(
        x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best
    )
    d_re = re_f[1:] * re_f[:-1] + im_f[1:] * im_f[:-1]
    d_im = im_f[1:] * re_f[:-1] - re_f[1:] * im_f[:-1]
    return d_re, d_im, score[best]


def _psk_frame_setup(samples: jnp.ndarray, spsym: int) -> Tuple[jnp.ndarray, int]:
    """Zero-pad a capture to a whole symbol count (f32 flat, n_frames).

    CEIL, not floor: at a timing offset o > 0 the final symbol's last o
    samples fall in the trailing partial block — flooring truncated them,
    corrupting exactly the frame's LAST dibit (the tail of the part CRC)
    whenever a capture's leading-silence length was ≢ 0 mod spsym
    (found by the round-3 randomized chaos sweep; the zero-pad keeps
    every real sample and an all-zero tail adds only one garbage dibit,
    which the parser ignores)."""
    n = samples.shape[-1]
    n_frames = -(-n // spsym)
    if n_frames < 2:
        raise ValueError("signal shorter than two symbols")
    x_flat = samples.astype(jnp.float32)
    if n_frames * spsym > n:
        x_flat = jnp.pad(x_flat, (0, n_frames * spsym - n))
    return x_flat, n_frames


def _psk_pass1(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk):
    """Pass 1 (shared): timing-offset selection from 3 contiguous windows.

    Returns ``(best, score)`` with score (n_offsets,). Score = energy-
    weighted phase coherence |Σ |d|²e^{jPθ_d}| at the data-cancelling power
    P. Raw energy is NOT a valid criterion here: the Gram-inverse dual basis
    amplifies misaligned-window projections, so a half-symbol-off hypothesis
    can carry more energy than the true one. At the true offset every
    differential phasor sits on a quarter-angle multiple (|e^{j4θ}| sums
    coherently, for DBPSK and DQPSK alike, and a CFO-induced common
    rotation doesn't change the magnitude); misaligned windows produce
    mixture angles that average the coherence toward zero. (8PSK data
    moves in π/4 steps, so its 4th power alternates ±1 and averages to
    zero on random tribits — that family scores with the 8th power.)
    """
    T = jnp.asarray(_offset_templates(spsym, float(carrier), sample_rate, n_offsets))
    dims = (((1,), (1,)), ((), ()))
    w = min(n_frames, 1 << 13)
    starts = sorted({0, max(0, (n_frames // 2 - w // 2)), max(0, n_frames - w)})
    subs = [
        jax.lax.dynamic_slice(x_flat, (s * spsym,), (w * spsym,)).reshape(w, spsym)
        for s in starts
    ]
    sub = jnp.concatenate(subs, axis=0)
    top = jax.lax.dot_general(T[:spsym].T, sub, dims, precision=matmul_precision())
    bot = jax.lax.dot_general(T[spsym:].T, sub, dims, precision=matmul_precision())
    proj = top + jnp.concatenate([bot[:, 1:], jnp.zeros((bot.shape[0], 1), jnp.float32)], axis=1)
    re, im = proj[0::2], proj[1::2]
    # Raw matched-energy units for cross-offset comparison (see _gram_scale).
    grams = jnp.asarray(_offset_grams(spsym, float(carrier), sample_rate, n_offsets))
    re, im = _gram_scale(re, im, grams, offset_axis=0)
    s_re = re[:, 1:] * re[:, :-1] + im[:, 1:] * im[:, :-1]
    s_im = im[:, 1:] * re[:, :-1] - re[:, 1:] * im[:, :-1]
    score = _coherence_score_pow(s_re, s_im, 1, n_psk)
    return jnp.argmax(score), score


def _psk_project_xla(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best):
    """Pass 2, XLA: raw per-symbol projection phasors at the winning offset.

    The blocked layout for small symbols, the (n_frames, spsym) template
    pair for large ones. Returns ``(re_f, im_f)`` of length >= n_frames
    (trailing block-pad entries are garbage the callers ignore)."""
    dims = (((1,), (1,)), ((), ()))
    if spsym <= _BLOCK_MAX_SPSYM:
        W = jnp.asarray(_blocked_templates(spsym, float(carrier), sample_rate, n_offsets))
        row = _BLOCK_SYM * spsym
        ov = W.shape[1] - row
        r = -(-n_frames // _BLOCK_SYM)  # ceil: rows of 128 symbols
        x_pad = jnp.pad(x_flat[: n_frames * spsym], (0, r * row + ov - n_frames * spsym))
        xr = x_pad[: r * row].reshape(r, row)
        xn = jnp.concatenate(
            [xr[1:, :ov], x_pad[r * row : r * row + ov][None, :]], axis=0
        )
        xov = jnp.concatenate([xr, xn], axis=1)  # (r, row+ov)
        out = jnp.matmul(xov, W[best], precision=matmul_precision())  # (r, 2*_BLOCK_SYM)
        return out[:, :_BLOCK_SYM].reshape(-1), out[:, _BLOCK_SYM:].reshape(-1)
    T = jnp.asarray(_offset_templates(spsym, float(carrier), sample_rate, n_offsets))
    T_best = jax.lax.dynamic_slice(T, (0, 2 * best), (2 * spsym, 2))
    x = x_flat[: n_frames * spsym].reshape(n_frames, spsym)
    top = jax.lax.dot_general(T_best[:spsym].T, x, dims, precision=matmul_precision())
    bot = jax.lax.dot_general(T_best[spsym:].T, x, dims, precision=matmul_precision())
    pj = top + jnp.concatenate([bot[:, 1:], jnp.zeros((2, 1), jnp.float32)], axis=1)
    return pj[0], pj[1]


def psk_symbol_streams(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RAW per-symbol projection phasors (pre-differential): (re, im, score).

    The DSSS despreader's front end: chips must sum coherently per data bit
    BEFORE any differential (differentials of consecutive chips carry data
    only at bit boundaries — despreading them would forfeit the processing
    gain). Shares pass 1/2 with :func:`psk_demod_streams`."""
    spsym = _samples_per_symbol(sample_rate, baud)
    x_flat, n_frames = _psk_frame_setup(samples, spsym)
    best, score = _psk_pass1(
        x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk
    )
    re_f, im_f = _psk_project_xla(
        x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best
    )
    return re_f, im_f, score[best]


def _fourth_power(d_re: jnp.ndarray, d_im: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Energy-normalized 4th power: |z|² e^{j4θ} as (re, im), no transcendentals.

    z² = (re²−im², 2·re·im); z⁴ = (z²)²; dividing by |z|² leaves a linear
    energy weight so strong symbols dominate but one outlier can't."""
    a = d_re * d_re
    b = d_im * d_im
    u = a - b
    v = 2 * d_re * d_im
    w = a + b + 1e-20
    return (u * u - v * v) / w, (2 * u * v) / w


def _coherence_parts(
    d_re: jnp.ndarray, d_im: jnp.ndarray, axis
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Σre4, Σim4) — the summed parts of the coherence score.

    Exposed separately so distributed callers (parallel/sequence.py) can
    psum the complex-sum components before taking the magnitude (summing
    local magnitudes would over-count incoherent shards)."""
    re4, im4 = _fourth_power(d_re, d_im)
    return jnp.sum(re4, axis=axis), jnp.sum(im4, axis=axis)


def _coherence_score(d_re: jnp.ndarray, d_im: jnp.ndarray, axis) -> jnp.ndarray:
    """Energy-weighted 4-fold phase coherence |Σ |z|² e^{j4θ}|.

    The *magnitude* of the complex 4th-power sum, not its real part: a
    carrier-frequency offset rotates every differential phasor by the same
    angle, which would scale Σcos4θ by cos(4·rotation) (zero at a π/8
    rotation — timing selection would collapse). The magnitude is
    rotation-invariant, so timing sync survives CFO.

    The energy weight must be the RAW matched-filter energy — callers scale
    the symbol phasors with :func:`_gram_scale` before differentials. The
    dual (Gram-inverse) projection this pipeline uses for phase recovery
    AMPLIFIES misaligned-window output at small spsym (measured: QPSK at
    spsym=5 — the wrong offset's unscaled weighted sum beat the true
    offset's 4.5x and every clean capture failed), while a PURELY normalized
    coherence fraction cannot rank BPSK offsets at all (an antipodal
    mixture stays perfectly 4-fold coherent; only its matched energy drops
    — measured as a CFO-tolerance regression at spsym=80). Weighting the
    4-fold coherence by ‖G·z‖² handles both regimes and picked the true
    offset in every measured case."""
    num_re, num_im = _coherence_parts(d_re, d_im, axis)
    return jnp.hypot(num_re, num_im)


def _eighth_power(d_re: jnp.ndarray, d_im: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Energy-normalized 8th power: |z|² e^{j8θ} as (re, im).

    Squares the 4th-power phasor and renormalizes by its magnitude (=|z|²),
    keeping the linear energy weight of :func:`_fourth_power` — 8PSK data
    sits on k·π/4 multiples, which only the 8th power cancels."""
    r4, i4 = _fourth_power(d_re, d_im)
    w = jnp.sqrt(r4 * r4 + i4 * i4) + 1e-20  # = |z|²
    return (r4 * r4 - i4 * i4) / w, (2 * r4 * i4) / w


def _coherence_score_pow(d_re, d_im, axis, n_psk: int) -> jnp.ndarray:
    """Timing-offset coherence at the data-cancelling power for ``n_psk``:
    the 4th power cancels DBPSK/DQPSK data, the 8th cancels D8PSK's."""
    if n_psk == 8:
        re8, im8 = _eighth_power(d_re, d_im)
        return jnp.hypot(jnp.sum(re8, axis=axis), jnp.sum(im8, axis=axis))
    return _coherence_score(d_re, d_im, axis)


def _coherence_parts_pow(
    d_re: jnp.ndarray, d_im: jnp.ndarray, axis, n_psk: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Summed complex parts of :func:`_coherence_score_pow` — for distributed
    callers (parallel/sequence.py) that psum the parts across shards before
    the magnitude (summing local magnitudes would over-count incoherent
    shards). 8th power for D8PSK, 4th otherwise."""
    if n_psk == 8:
        re8, im8 = _eighth_power(d_re, d_im)
        return jnp.sum(re8, axis=axis), jnp.sum(im8, axis=axis)
    return _coherence_parts(d_re, d_im, axis)


@functools.lru_cache(maxsize=64)
def _offset_grams(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, 3) per-offset Gram entries (gxx, gxy, gyy) of the raw
    symbol basis — used to convert dual-projection phasors back to raw
    matched-filter energy units for timing scoring (see _gram_scale)."""
    t = np.arange(2 * spsym, dtype=np.float64)
    w = 2 * np.pi * carrier * t / sample_rate
    env = np.ones(spsym)
    ramp = int(spsym * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    G = np.zeros((n_offsets, 3), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spsym // n_offsets
        B = np.stack(
            [np.sin(w[o : o + spsym]) * env, np.cos(w[o : o + spsym]) * env], axis=1
        )
        g = B.T @ B
        G[i] = (g[0, 0], g[0, 1], g[1, 1])
    return G


def _gram_scale(
    re: jnp.ndarray, im: jnp.ndarray, grams: jnp.ndarray, offset_axis: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scale dual-basis phasors to raw matched-energy magnitude, per offset.

    ``z = G⁻¹·(Bᵀx)`` is the unbiased phase estimate; ``G·z = Bᵀx`` is the
    raw correlation. Multiplying ``z`` by the SCALAR ‖G·z‖/‖z‖ preserves its
    angle (so differentials and the 4-fold coherence are untouched) while
    making ‖z'‖² the raw matched energy — the valid cross-offset weight for
    timing scoring (the dual's amplification of misaligned windows cancels).
    ``grams`` is ``_offset_grams``'s (n_offsets, 3); ``offset_axis`` is the
    axis of ``re``/``im`` indexing the offset hypothesis."""
    shape = [1] * re.ndim
    shape[offset_axis] = grams.shape[0]
    gxx = grams[:, 0].reshape(shape)
    gxy = grams[:, 1].reshape(shape)
    gyy = grams[:, 2].reshape(shape)
    a = gxx * re + gxy * im
    c = gxy * re + gyy * im
    s = jnp.sqrt((a * a + c * c) / (re * re + im * im + 1e-20))
    return re * s, im * s


def estimate_cfo(
    samples, baud: float, carrier: float, sample_rate: int
) -> float:
    """Carrier-frequency-offset estimate in Hz (resolved mod ``baud/4``).

    A CFO on this wire format cannot scatter the per-symbol projection: the
    modulator restarts the carrier phase each symbol (ops reference:
    /root/reference/modem.py:54,177 behavior), so a carrier offset appears
    purely as a CONSTANT rotation 2pi*delta/baud of every differential
    phasor. The blind 4th-power rotation estimate therefore IS the CFO
    measurement: delta_hat = baud*theta_hat/2pi, mod baud/4 (the k*pi/2
    sector ambiguity, which the demodulator's quarter-turn sync retry
    absorbs). Correction needs no signal retuning at all; this function is
    for diagnostics and the tolerance benchmark.
    """
    d_re, d_im, _ = psk_demod_streams(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(sample_rate)
    )
    theta = float(estimate_common_rotation(d_re, d_im))
    return theta * float(baud) / (2 * np.pi)



def estimate_common_rotation(d_re: jnp.ndarray, d_im: jnp.ndarray) -> jnp.ndarray:
    """Blind CFO estimate: the common rotation of the differential phasors.

    A carrier frequency offset Δf adds a constant 2πΔf/baud to every
    differential angle. The 4th power cancels both DBPSK (0/π) and DQPSK
    (k·π/2) data, leaving 4·rotation: θ̂ = arg(Σ |z|²e^{j4θ})/4, resolved
    mod π/2 (the residual k·π/2 ambiguity is a Gray-sector relabeling,
    handled by the sync-stage rotation retry). Reduces over the last axis.
    """
    re4, im4 = _fourth_power(d_re, d_im)
    return jnp.arctan2(jnp.sum(im4, axis=-1), jnp.sum(re4, axis=-1)) / 4


def estimate_common_rotation8(d_re: jnp.ndarray, d_im: jnp.ndarray) -> jnp.ndarray:
    """Blind CFO estimate for D8PSK: θ̂ = arg(Σ |z|²e^{j8θ})/8, resolved mod
    π/4 — the residual k·π/4 ambiguity is a Gray-sector relabeling handled
    by the 8-hypothesis rotation sync (:func:`psk8_sync_and_pack_rotations`).
    Noisier than the 4th-power estimate (the 8th power doubles the angular
    noise gain), so the sync ladder keeps the underotated fallback."""
    re8, im8 = _eighth_power(d_re, d_im)
    return jnp.arctan2(jnp.sum(im8, axis=-1), jnp.sum(re8, axis=-1)) / 8


def estimate_common_rotation_windows(
    d_re: jnp.ndarray, d_im: jnp.ndarray, win: int = 1 << 15, n_psk: int = 4
) -> jnp.ndarray:
    """Rotation estimate from 3 contiguous windows instead of the full array.

    The estimate converges within a few thousand symbols; reading the whole
    multi-megasymbol diff stream for it costs a full HBM pass in the fused
    pipeline. Three spread windows keep coverage (leading/trailing silence
    contributes ~zero energy weight). Reduces over the last axis.
    """
    est = estimate_common_rotation8 if n_psk == 8 else estimate_common_rotation
    n = d_re.shape[-1]
    if n <= 3 * win:
        return est(d_re, d_im)
    starts = (0, (n - win) // 2, n - win)
    sl_re = jnp.concatenate([d_re[..., s : s + win] for s in starts], axis=-1)
    sl_im = jnp.concatenate([d_im[..., s : s + win] for s in starts], axis=-1)
    return est(sl_re, sl_im)


def derotate(
    d_re: jnp.ndarray, d_im: jnp.ndarray, theta: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotate differential phasors by −θ (θ broadcasts over leading axes)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    if d_re.ndim > getattr(theta, "ndim", 0):
        c, s = c[..., None], s[..., None]
    return d_re * c + d_im * s, d_im * c - d_re * s


def quarter_turn(d_re: jnp.ndarray, d_im: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotate by −k·π/2 exactly (sign/swap only) — the CFO ambiguity retry."""
    k %= 4
    if k == 0:
        return d_re, d_im
    if k == 1:
        return d_im, -d_re
    if k == 2:
        return -d_re, -d_im
    return -d_im, d_re


def _batch_pass1(samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r_pre, n_psk=4):
    """Shared batched pass 1: build the blocked row tensor, score every
    timing offset on up to 3 row windows, and blind-estimate each capture's
    common differential rotation (the CFO signature) from the winning
    offset's window differentials — the full diff stream is never read for
    the estimate.

    Returns ``(x3d, r, best, theta)`` with best (B,) int32 and theta (B,).
    """
    W8 = jnp.asarray(_blocked_templates(spsym, float(carrier), sample_rate, n_offsets))
    row = _BLOCK_SYM * spsym
    c = W8.shape[1]
    ov = c - row
    blk = 256
    if x3d is None:
        # CEIL row count and keep EVERY input sample (pad, don't slice):
        # flooring either dropped the trailing partial block — at a timing
        # offset > 0 that truncates the final symbol's tail and corrupts the
        # frame's last dibits (the part-CRC tail), the same defect the
        # round-3 chaos sweep exposed in the single-capture paths. The
        # host pre-shaping path (blocked_row_shape) already keeps the tail.
        r0 = -(-n_frames // _BLOCK_SYM)
        r = max(blk, -(-r0 // blk) * blk)
        x = samples.astype(jnp.float32)
        x_pad = jnp.pad(x, ((0, 0), (0, r * row - x.shape[1])))
        x3d = x_pad.reshape(b, r, row)
    else:
        r = r0 = r_pre
        if r % blk:
            raise ValueError(f"pre-shaped rows {r} must be a multiple of {blk}")

    # Slice the windows FIRST, then build their overlap tails: constructing
    # the overlap for every row of the full batch profiled at ~12% of the
    # pipeline while pass 1 only reads ~1.5% of the rows.
    wr = min(64, r0) if r0 >= 1 else 1
    starts = sorted({0, max(0, r0 // 2 - wr // 2), max(0, r0 - wr)})
    mains = [x3d[:, s : s + wr] for s in starts]
    # Next-row heads; dynamic_slice_in_dim clamps at the array edge (the last
    # window shifts by one row there — irrelevant for scoring).
    nexts = [
        jax.lax.dynamic_slice_in_dim(x3d, min(s + 1, r0 - wr + 1 if r0 >= wr else 0), wr, axis=1)[
            :, :, :ov
        ]
        for s in starts
    ]
    wins = jnp.concatenate(
        [jnp.concatenate([m, nx], axis=2) for m, nx in zip(mains, nexts)], axis=1
    ).astype(jnp.float32)  # (B, len(starts)*wr, row+ov); int16 rows cast here
    # Normalize the SCORING/CFO windows per capture: the 4th-power rotation
    # estimate raises differential phasors (~scale^2) to the 4th, so int16-
    # scaled input (x32768 -> ~1e36 per term) overflows f32 to inf and the
    # arctan2 to nan. The estimate is mathematically scale-invariant; this
    # keeps it numerically so for ANY input scale. Pass 2's sign decisions
    # are scale-invariant and keep the raw values.
    wscale = jnp.maximum(jnp.max(jnp.abs(wins), axis=(1, 2), keepdims=True), 1e-12)
    wins = wins / wscale
    W_all = jnp.concatenate([W8[i] for i in range(n_offsets)], axis=1)  # (c, K*256)
    proj = jnp.matmul(wins.reshape(b, -1, c), W_all, precision=matmul_precision())  # (B, nw, K*256)
    proj = proj.reshape(b, -1, n_offsets, 2, _BLOCK_SYM)
    re, im = proj[:, :, :, 0], proj[:, :, :, 1]  # (B, nw, K, 128)
    grams = jnp.asarray(_offset_grams(spsym, float(carrier), sample_rate, n_offsets))
    re, im = _gram_scale(re, im, grams, offset_axis=2)
    # In-row differentials (127 per row) are plenty for scoring.
    dr = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    di = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    score = _coherence_score_pow(dr, di, (1, 3), n_psk)  # (B, K)
    best = jnp.argmax(score, axis=1).astype(jnp.int32)

    # Per-capture blind rotation estimate from the winning offset's windows
    # (converges within a few thousand symbols; these windows hold ~24k).
    idx = best[:, None, None, None]
    dr_b = jnp.take_along_axis(dr, idx, axis=2)[:, :, 0]  # (B, nw, 127)
    di_b = jnp.take_along_axis(di, idx, axis=2)[:, :, 0]
    est = estimate_common_rotation8 if n_psk == 8 else estimate_common_rotation
    theta = est(dr_b.reshape(b, -1), di_b.reshape(b, -1))
    return x3d, r, best, theta


def _batch_block_setup(samples: jnp.ndarray, spsym: int):
    """Shared 3D/flat input setup for the batched blocked receivers.

    ``(B, r, 128*spsym)`` pre-shaped rows (``blocked_row_shape``) pass
    through (integer rows are cast to f32 by the pass-2 einsum);
    flat ``(B, N)`` captures return ``x3d=None`` for pass 1 to build the
    rows on device. Returns ``None`` when the caller must take its vmapped
    single-capture fallback (symbol too large / capture too short to
    block); otherwise ``(b, n_frames, x3d, r)`` with ``r=0`` for flat
    input. Shapes are static under jit, so the gate is plain Python."""
    if samples.ndim == 3:
        b, r, row = samples.shape
        if row != _BLOCK_SYM * spsym:
            raise ValueError(f"row width {row} != 128*spsym ({_BLOCK_SYM * spsym})")
        n_frames = r * _BLOCK_SYM
        x3d = samples if jnp.issubdtype(samples.dtype, jnp.integer) else samples.astype(jnp.float32)
        return b, n_frames, x3d, r
    b, n = samples.shape
    n_frames = -(-n // spsym)  # ceil — keep the trailing partial symbol
    if spsym > _BLOCK_MAX_SPSYM or n_frames < 2 * _BLOCK_SYM:
        return None
    return b, n_frames, None, 0


def _blocked_project_xla(
    x3d: jnp.ndarray, W8: jnp.ndarray, best: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pass-2 blocked projection (XLA path): overlap-row build + ONE einsum
    against each capture's winning-offset template. Returns the raw
    per-symbol phasors ``(re_f, im_f)`` of shape (B, n_out). Integer rows
    cast to f32 here (the einsum operand must be float either way)."""
    b = x3d.shape[0]
    ov = W8.shape[1] - x3d.shape[2]
    x3d = x3d.astype(jnp.float32)
    x_next = jnp.concatenate([x3d[:, 1:, :ov], jnp.zeros((b, 1, ov), jnp.float32)], axis=1)
    xov_rows = jnp.concatenate([x3d, x_next], axis=2)  # (B, r, row+ov)
    out = jnp.einsum(  # (B, r, 256)
        "brc,bck->brk", xov_rows, W8[best], precision=matmul_precision()
    )
    re_f = out[:, :, :_BLOCK_SYM].reshape(b, -1)
    im_f = out[:, :, _BLOCK_SYM:].reshape(b, -1)
    return re_f, im_f


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "n_offsets", "n_psk")
)
def psk_demod_streams_batch(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched (B, N) differential phasor streams.

    Differences from vmapping :func:`psk_demod_streams`:

    * Pass-1 timing scores come from the same blocked row layout as pass 2
      (one matmul against all offsets' templates side by side) instead of a
      (frames, spsym) reshape.
    * Pass 2 is ONE einsum over the whole batch, each capture's template
      chosen by its winning offset. Large symbols take the per-capture path.

    Returns ``(d_re, d_im)`` of shape (B, n_out); trailing entries per capture
    are garbage (pad symbols), which downstream sync/parse ignores.
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        d_re, d_im, _ = jax.vmap(
            lambda s: psk_demod_streams(s, baud, carrier, sample_rate, n_offsets, n_psk)
        )(samples)
        return d_re, d_im
    b, n_frames, x3d, r = setup

    x3d, r, best, _theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r, n_psk,
    )
    W8 = jnp.asarray(_blocked_templates(spsym, float(carrier), sample_rate, n_offsets))

    re_f, im_f = _blocked_project_xla(x3d, W8, best)
    d_re = re_f[:, 1:] * re_f[:, :-1] + im_f[:, 1:] * im_f[:, :-1]
    d_im = im_f[:, 1:] * re_f[:, :-1] - re_f[:, 1:] * im_f[:, :-1]
    return d_re, d_im


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "n_offsets", "n_psk")
)
def psk_raw_streams_batch(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched RAW per-symbol projection phasors — pre-differential.

    The DSSS despreader's batch front end (:mod:`.dsss`): chips must sum
    coherently per data bit BEFORE any differential. Shares pass 1 (blocked timing scores + per-capture offset select) with
    :func:`psk_demod_streams_batch`; pass 2 is the batched blocked einsum at
    each capture's winning offset. Accepts flat (B, N) captures or
    pre-shaped (B, r, 128*spsym) rows (``blocked_row_shape``).

    Returns ``(re_f, im_f)`` of shape (B, n_out >= n_frames); trailing
    entries per capture are zero-pad garbage downstream alignment ignores.
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        re_f, im_f, _ = jax.vmap(
            lambda s: psk_symbol_streams(s, baud, carrier, sample_rate, n_offsets, n_psk)
        )(samples)
        return re_f, im_f
    b, n_frames, x3d, r = setup

    x3d, r, best, _theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r, n_psk,
    )
    W8 = jnp.asarray(_blocked_templates(spsym, float(carrier), sample_rate, n_offsets))
    return _blocked_project_xla(x3d, W8, best)


def _decide_streams(d_re, d_im, n_psk: int):
    """Float differential streams -> uint8 decision streams (XLA path)."""
    if n_psk == 4:
        return qpsk_gray_streams(d_re, d_im)
    return (d_re < 0).astype(jnp.uint8), (d_im < 0).astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "n_psk", "cfo", "n_offsets")
)
def psk_decision_streams_batch(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_psk: int = 4,
    cfo: bool = True,
    n_offsets: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched decision streams — the production receive hot path.

    Returns uint8 ``(hi, lo)`` Gray dibit lanes (``n_psk=4``) or the sign
    bits of the (re, im) differential (``n_psk=2``), shape (B, n_out).

    Pass 2 is the blocked projection einsum, the differential, per-capture
    blind derotation (``cfo=True``; the θ estimate comes from the pass-1
    scoring windows, so the full diff stream is never read for it) and the
    bit decision — elementwise stages XLA fuses behind the einsum. Large
    symbols take the vmapped single-capture float path.
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        d_re, d_im = psk_demod_streams_batch(
            samples, baud, carrier, sample_rate, n_offsets
        )
        if cfo:
            theta = estimate_common_rotation_windows(d_re, d_im)
            d_re, d_im = derotate(d_re, d_im, theta)
        return jax.vmap(lambda a, c: _decide_streams(a, c, n_psk))(d_re, d_im)
    b, n_frames, x3d, r = setup

    x3d, r, best, theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r,
    )
    W8 = jnp.asarray(_blocked_templates(spsym, float(carrier), sample_rate, n_offsets))
    re_f, im_f = _blocked_project_xla(x3d, W8, best)
    d_re = re_f[:, 1:] * re_f[:, :-1] + im_f[:, 1:] * im_f[:, :-1]
    d_im = im_f[:, 1:] * re_f[:, :-1] - re_f[:, 1:] * im_f[:, :-1]
    if cfo:
        d_re, d_im = derotate(d_re, d_im, theta)
    return jax.vmap(lambda a, c: _decide_streams(a, c, n_psk))(d_re, d_im)


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "cfo", "n_offsets")
)
def psk8_sector_rows_batch(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    cfo: bool = True,
    n_offsets: int = 8,
) -> jnp.ndarray:
    """Batched D8PSK sector stream: uint8 π/4 sectors of shape (B, n_out).

    :func:`psk_demod_streams_batch` (8th-power timing scores), then with
    ``cfo`` a per-capture blind rotation estimate from three stream windows
    and its derotation, then the elementwise 8-sector decision — the input
    of :func:`psk8_sync_and_pack_rotations`.
    """
    d_re, d_im = psk_demod_streams_batch(
        samples, baud, carrier, sample_rate, n_offsets, n_psk=8
    )
    if cfo:
        theta = estimate_common_rotation_windows(d_re, d_im, n_psk=8)
        d_re, d_im = derotate(d_re, d_im, theta)
    return psk8_sector_stream(d_re, d_im)


def blocked_row_shape(n_samples: int, baud: float, sample_rate: int) -> Optional[Tuple[int, int]]:
    """Host helper: (rows, row_width) for pre-shaping a capture of
    ``n_samples`` for :func:`psk_demod_streams_batch`, or None when the
    config has no blocked fast path (large symbols)."""
    spsym = _samples_per_symbol(sample_rate, baud)
    if spsym > _BLOCK_MAX_SPSYM:
        return None
    # Ceil everywhere (symbols, then rows): flooring dropped the trailing
    # partial symbol/block, corrupting the frame's final dibits whenever a
    # capture's leading silence was ≢ 0 mod spsym (round-3 chaos sweep).
    n_frames = -(-n_samples // spsym)
    if n_frames < 2 * _BLOCK_SYM:
        return None
    row = _BLOCK_SYM * spsym
    blk = 256
    rows = -(-n_frames // _BLOCK_SYM)
    r = max(blk, -(-rows // blk) * blk)
    return r, row


def qpsk_gray_streams(d_re: jnp.ndarray, d_im: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Differential phasor -> (hi, lo) Gray dibit streams, sign/compare only.

    Sector boundaries at +-45/+-135 degrees: |re|>=|im|, re>0 -> 00;
    |im|>|re|, im>0 -> 01; |re|>=|im|, re<0 -> 11; |im|>|re|, im<0 -> 10.
    """
    swap = jnp.abs(d_im) > jnp.abs(d_re)
    neg = jnp.where(swap, d_im < 0, d_re < 0)  # dominant component negative?
    hi = neg.astype(jnp.uint8)
    lo = jnp.where(swap, ~neg, neg).astype(jnp.uint8)
    return hi, lo


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "n_psk", "n_offsets")
)
def psk_demod_bits(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_psk: int,
    n_offsets: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate D(B/Q)PSK to an interleaved bit array.

    Generic-bit-stream API; the batched hot path uses
    :func:`psk_demod_streams` + the dual-stream byte packer instead, which
    avoids materializing the interleaved (n, 2) layout.

    Deliberately NO blind derotation here: the 4th-power estimate resolves
    the channel rotation only mod π/2, and this API has no frame-sync stage
    to try the quarter-turn relabelings — derotating would turn e.g. a
    static 60° phase offset (decodable as-is, margin cos60°) into a 90°
    offset (undecodable). CFO handling lives in the synced byte paths
    (:func:`_psk_bytes_cfo`, parallel/batch.py).
    """
    d_re, d_im, best_score = psk_demod_streams(samples, baud, carrier, sample_rate, n_offsets)
    if n_psk == 2:
        bits = (d_re < 0).astype(jnp.uint8)
    else:
        hi, lo = qpsk_gray_streams(d_re, d_im)
        bits = jnp.stack([hi, lo], axis=1).reshape(-1)
    return bits, best_score


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "sample_rate", "n_psk", "pattern", "pattern2"),
)
def _psk_bytes_cfo(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int, n_psk: int,
    pattern: str, pattern2: str = "",
):
    """CFO-robust demod to bytes: derotation + quarter-turn rotation sync.

    The blind 4th-power CFO estimate resolves the common rotation mod π/2;
    the residual k·π/2 relabels every Gray sector (DQPSK) or inverts/swaps
    the bit stream (DBPSK). The rotation sync matches the magic under all
    four relabelings (cheap) and packs bytes once (ops/common.py)."""
    from .common import bit_sync_and_pack_rotations, dibit_sync_and_pack_rotations

    from .common import dibit_sync_and_pack, find_bit_pattern, pack_bits_from

    d_re0, d_im0, _ = psk_demod_streams(samples, baud, carrier, sample_rate)
    d_re, d_im = derotate(d_re0, d_im0, estimate_common_rotation(d_re0, d_im0))

    # The rotation syncs validate their own matches when ``pattern2`` is
    # given (the 16 bits following the pattern must also look like the
    # magic): the 16-bit x 8-hypothesis match false-fires ~8x per noisy
    # megadibit capture, and a false hypothesis RELABELS the whole stream
    # (the reference's plain stream has no such failure mode — the
    # BER-parity harness caught us 2-6x worse at junk SNR). Ladder:
    # validated rotation sync on the derotated stream -> validated rotation
    # sync underotated (junk blind theta on a carrier-exact capture) ->
    # plain parity-only sync underotated, which at worst shifts the pack
    # offset like the reference. Custom patterns (pattern2="") skip
    # validation by design.
    def _validated(res):
        return res[2]

    if n_psk == 2:
        bits_re = (d_re < 0).astype(jnp.uint8)
        bits_im = (d_im < 0).astype(jnp.uint8)
        b0_re = (d_re0 < 0).astype(jnp.uint8)
        b0_im = (d_im0 < 0).astype(jnp.uint8)
        res1 = bit_sync_and_pack_rotations(bits_re, bits_im, pattern, pattern2)

        def _fallback_bpsk():
            res2 = bit_sync_and_pack_rotations(b0_re, b0_im, pattern, pattern2)

            def _plain():
                start, found = find_bit_pattern(b0_re, pattern)
                packed, n_valid = pack_bits_from(b0_re, start)
                return packed, n_valid, found

            return jax.lax.cond(_validated(res2), lambda: res2, _plain)

        return jax.lax.cond(_validated(res1), lambda: res1, _fallback_bpsk)

    hi, lo = qpsk_gray_streams(d_re, d_im)
    hi0, lo0 = qpsk_gray_streams(d_re0, d_im0)
    res1 = dibit_sync_and_pack_rotations(hi, lo, pattern, pattern2)

    def _fallback_qpsk():
        res2 = dibit_sync_and_pack_rotations(hi0, lo0, pattern, pattern2)
        return jax.lax.cond(
            _validated(res2),
            lambda: res2,
            lambda: dibit_sync_and_pack(hi0, lo0, pattern),
        )

    return jax.lax.cond(_validated(res1), lambda: res1, _fallback_qpsk)


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "n_psk")
)
def _psk_bytes_nosync(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int, n_psk: int
):
    """Demod to bytes with NO magic sync: derotate blind, pack from offset 0.

    The synced paths discard everything before the first 16-bit magic match
    — correct when the magic survived, catastrophic when it took bit errors
    (a spurious match truncates the head of the capture, frame included).
    This is the header-tolerant recovery front end: the full bit stream,
    byte-packed from offset 0 under rotation k=0; the decoder's rescue sweep
    (decoder.recover_header_damaged) then searches all bit shifts and
    quarter-turn relabelings of it. Returns a list of (packed, n_valid)
    pairs: one stream for DQPSK, the (re, im) pair for DBPSK.
    """
    from .common import pack_bits_from

    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation(d_re, d_im))
    if n_psk == 2:
        out = []
        for comp in ((d_re < 0), (d_im < 0)):
            packed, n_valid = pack_bits_from(comp.astype(jnp.uint8), jnp.int32(0))
            out.append((packed, n_valid))
        return out
    from .common import relabel_shift_pack

    hi, lo = qpsk_gray_streams(d_re, d_im)
    packed, n_valid = relabel_shift_pack(hi, lo, jnp.int32(0), jnp.int32(0))
    return [(packed, n_valid)]


def psk_nosync_streams(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int, n_psk: int
) -> list:
    """Host wrapper for :func:`_psk_bytes_nosync`: list of full byte streams."""
    pairs = _psk_bytes_nosync(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), int(n_psk),
    )
    return [bytes(np.asarray(p)[: int(n)]) for p, n in pairs]


def psk_soft_bits(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int, n_psk: int
) -> np.ndarray:
    """Soft bit stream in [0, 1] (P(bit=1)-ish) from capture start.

    For DQPSK the diagonal rotation trick makes both Gray bits INDEPENDENT
    signs: with diff phasor (u, v), hi = sign(-(u+v)) and lo = sign(v-u)
    (sector boundaries at odd π/4 become the axes of (u+v, v-u)), so each
    bit's soft value is a linear scaling of its own component — a proper
    input for the soft Viterbi (fec.stream_fec_decode soft path). DBPSK
    uses -d_re directly. CFO derotation applies as in the hard path (the
    k·π/2 ambiguity is the stream-FEC caller's problem: coded streams carry
    no sector meaning, so only k=0 matters after derotation).
    """
    d_re, d_im, _ = psk_demod_streams(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(samp_rate)
    )
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation(d_re, d_im))
    d_re, d_im = np.asarray(d_re), np.asarray(d_im)
    scale = np.mean(np.abs(d_re) + np.abs(d_im)) + 1e-9
    if n_psk == 2:
        return np.clip(0.5 - d_re / scale, 0.0, 1.0).astype(np.float32)
    a = d_re + d_im  # hi = 1 when a < 0
    b = d_im - d_re  # lo = 1 when b > 0
    soft = np.empty(2 * len(a), np.float32)
    soft[0::2] = np.clip(0.5 - a / scale, 0.0, 1.0)
    soft[1::2] = np.clip(0.5 + b / scale, 0.0, 1.0)
    return soft


def _demod_to_bytes(samples: np.ndarray, baud, carrier, samp_rate, n_psk, pattern) -> bytes:
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    # CFO handling needs no front-end correction on this wire format: a
    # carrier offset is exactly a constant differential rotation (see
    # estimate_cfo), which the blind derotation + rotation sync absorbs.
    packed, n_valid, _found = _psk_bytes_cfo(
        jnp.asarray(samples, jnp.float32),
        float(baud),
        float(carrier),
        int(samp_rate),
        n_psk,
        pattern or MAGIC_BIT_PATTERN,
        MAGIC_BIT_PATTERN2 if not pattern else "",
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


def bpsk_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """DBPSK receive chain: bits -> magic-aligned bytes."""
    return _demod_to_bytes(samples, baud, carrier, samp_rate, 2, None)


def qpsk_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """DQPSK receive chain: dibits -> magic-aligned bytes."""
    return _demod_to_bytes(samples, baud, carrier, samp_rate, 4, None)


# --- D8PSK (real 8-phase mode) -------------------------------------------------
#
# The reference's "8PSK" is an alias that transmits DQPSK and throws away the
# promised third bit (/root/reference/modem.py:345; its own efficiency map
# claims 3·rate/8 bytes/s, encoder.py:66-73). This section implements the mode
# the reference advertises: differential 8-PSK, Gray-coded tribits, 1.5x the
# DQPSK bit rate at the same baud. The wire format is ours (the reference has
# none to match); modem.py keeps the alias behind ``modem.psk8_compat_alias``
# and probe-falls-back on alias-generated captures, the real-OFDM pattern.
#
# Same array-first architecture as DQPSK: the projection/differential front end
# is shared verbatim (psk_demod_streams, n_psk=8 for 8th-power timing scores),
# sector decisions are pure elementwise compares (no (n, 8) argmax layout —
# a minor dim of 8 pads to 128 lanes), and the rotation sync transforms the
# magic PATTERN 8 ways on the host instead of relabeling the stream 8 times.

_ET_SQ = float(np.sqrt(0.5))
# cos/sin of k·π/4 — the 8PSK constellation directions.
_ET_COS = np.array([1, _ET_SQ, 0, -_ET_SQ, -1, -_ET_SQ, 0, _ET_SQ], np.float64)
_ET_SIN = np.array([0, _ET_SQ, 1, _ET_SQ, 0, -_ET_SQ, -1, -_ET_SQ], np.float64)
# 3-bit reflected Gray code: sector k carries tribit value _GRAY8[k]
# (adjacent sectors differ in one bit), inverse maps tribit -> phase delta.
_GRAY8 = np.array([0, 1, 3, 2, 6, 7, 5, 4], np.uint8)
_GRAY8_INV = np.argsort(_GRAY8).astype(np.uint8)

# 40 symbols: 30 zero-deltas then 10 half-turn deltas — the same carrier
# settle + timing-energy shape as QPSK_PREAMBLE_BITS, in tribit space.
# 120 bits ≡ 0 mod 3, so the frame magic always lands tribit-aligned.
PSK8_PREAMBLE_BITS = [0, 0, 0] * 30 + [1, 1, 0] * 10


@functools.partial(jax.jit, static_argnames=("spsym", "carrier", "sample_rate"))
def _synthesize8(phase_et: jnp.ndarray, spsym: int, carrier: float, sample_rate: int) -> jnp.ndarray:
    """Eighth-turn phase indices (n_sym,) -> waveform, same matmul synthesis
    as :func:`_synthesize` with the 8-entry unit-circle table."""
    basis = jnp.asarray(_carrier_basis(spsym, carrier, sample_rate))
    cs = jnp.stack(
        [jnp.asarray(_ET_COS, jnp.float32)[phase_et], jnp.asarray(_ET_SIN, jnp.float32)[phase_et]],
        axis=1,
    )
    return jnp.matmul(cs, basis, precision=matmul_precision()).reshape(-1)


def psk8_real_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """D8PSK: Gray-coded tribit phase deltas, 3 bits/symbol."""
    bits = np.concatenate(
        [np.asarray(PSK8_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    )
    if len(bits) % 3:
        bits = np.concatenate([bits, np.zeros(3 - len(bits) % 3, np.uint8)])
    tri = bits[0::3].astype(np.int64) * 4 + bits[1::3] * 2 + bits[2::3]
    deltas = _GRAY8_INV[tri].astype(np.int64)
    phase_et = (np.cumsum(deltas) % 8).astype(np.int32)
    spsym = _samples_per_symbol(samp_rate, baud)
    n_sym = len(phase_et)
    phase_et = np.pad(phase_et, (0, _bucket_symbols(n_sym) - n_sym))
    out = _synthesize8(jnp.asarray(phase_et), spsym, float(carrier), int(samp_rate))
    return np.asarray(out)[: n_sym * spsym]


def psk8_sector_stream(d_re: jnp.ndarray, d_im: jnp.ndarray) -> jnp.ndarray:
    """Differential phasor -> nearest k·π/4 sector, compares only.

    Boundaries at 22.5°+k·45°: a phasor is an AXIS sector when one component
    dominates by more than tan(67.5°) (|v| ≤ tan(22.5°)·|u| or vice versa),
    a DIAGONAL sector otherwise — all elementwise, no (n, 8) score
    array."""
    t = float(np.tan(np.pi / 8))
    a, b = d_re, d_im
    ax, bx = jnp.abs(a), jnp.abs(b)
    diag = (bx > t * ax) & (ax > t * bx)
    horiz = ax >= bx
    k_axis = jnp.where(
        horiz,
        jnp.where(a >= 0, 0, 4),
        jnp.where(b >= 0, 2, 6),
    )
    k_diag = jnp.where(
        b >= 0,
        jnp.where(a >= 0, 1, 3),
        jnp.where(a >= 0, 7, 5),
    )
    return jnp.where(diag, k_diag, k_axis).astype(jnp.uint8)


def _psk8_expected_sectors(pattern: str, k: int) -> list:
    """Host transform: the bit pattern as the RECEIVED sector sequence under
    a channel rotation of k·π/4. Only full tribits transform (a rotation
    relabels whole symbols); trailing 1-2 pattern bits are dropped by the
    caller's split logic."""
    out = []
    for t in range(0, len(pattern) - 2, 3):
        tri = int(pattern[t]) * 4 + int(pattern[t + 1]) * 2 + int(pattern[t + 2])
        out.append((int(_GRAY8_INV[tri]) + k) % 8)
    return out


def _psk8_gray_bits(sec: jnp.ndarray) -> jnp.ndarray:
    """Sector stream (m,) -> interleaved Gray bit stream (3m,) uint8."""
    g = sec ^ (sec >> 1)
    lanes = jnp.stack([(g >> 2) & 1, (g >> 1) & 1, g & 1], axis=1)
    return lanes.reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("pattern", "pattern2", "tol", "n_rotations")
)
def psk8_sync_and_pack_rotations(
    sec: jnp.ndarray, pattern: str, pattern2: str = "", tol: int = 3,
    n_rotations: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sync + byte-pack a D8PSK sector stream under the 8 π/4-rotation
    CFO hypotheses.

    The wire format keeps the frame magic tribit-aligned (the preamble is a
    whole number of tribits), so matching runs in SECTOR space at symbol
    granularity: the pattern transforms 8 ways on the host
    (:func:`_psk8_expected_sectors`), full tribits of the exact region match
    as sector equality, the validation region counts Gray-bit mismatches via
    the 3-bit popcount of the sector XOR (tolerance semantics identical to
    the dibit sync). The stream relabels and packs ONCE on the winning
    hypothesis. ``n_rotations=1`` accepts only the unrotated hypothesis
    (carrier-exact channels: a rotated stream must not silently decode).
    Returns ``(packed, n_valid, found)``.
    """
    m = sec.shape[0]
    both = pattern + pattern2
    n_sym_pat = len(both) // 3  # full tribits only (trailing bits dropped)
    n_exact_sym = len(pattern) // 3  # symbols fully inside the exact region
    L = m - n_sym_pat + 1
    g_rx = sec ^ (sec >> 1)

    starts, founds = [], []
    for k in range(n_rotations):
        exp = _psk8_expected_sectors(both, k)
        match = jnp.ones((L,), dtype=bool)
        miss = jnp.zeros((L,), jnp.int32)
        for j, e in enumerate(exp):
            if j < n_exact_sym:
                match &= sec[j : j + L] == e
            else:
                x = g_rx[j : j + L] ^ (e ^ (e >> 1))
                bits_off = (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1)
                if j == n_exact_sym and len(pattern) % 3:
                    # Straddling symbol: its leading len(pattern)%3 bits are
                    # in the exact region — match them exactly. At surviving
                    # positions those bits XOR to 0, so ``bits_off`` counts
                    # only the trailing (tolerant) bits.
                    lead_mask = (0, 0b100, 0b110)[len(pattern) % 3]
                    match &= (x & lead_mask) == 0
                miss = miss + bits_off
        if pattern2:
            match &= miss <= tol
        idx = jnp.argmax(match).astype(jnp.int32)
        founds.append(match[idx])
        starts.append(jnp.where(match[idx], idx, 0))

    found8 = jnp.stack(founds)
    start8 = jnp.stack(starts)
    ksel = jnp.argmax(found8)  # first found rotation, else 0
    idx = start8[ksel]
    found = found8[ksel]

    st = (sec.astype(jnp.int32) + (8 - ksel)) % 8  # relabel: true = rx − k
    bits = _psk8_gray_bits(st.astype(jnp.uint8))
    packed, n_valid = pack_bits_from(bits, 3 * idx)
    return packed, n_valid, found


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "sample_rate", "pattern", "pattern2")
)
def _psk8_bytes_cfo(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    pattern: str, pattern2: str = "",
):
    """CFO-robust D8PSK demod to bytes — the DQPSK ladder at π/4 granularity:
    validated rotation sync on the 8th-power-derotated sector stream, then
    underotated (a junk blind θ̂ on a carrier-exact capture), then a plain
    k=0 pack from offset 0 (the header-tolerant rescue's input)."""
    d_re0, d_im0, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re0, d_im0, estimate_common_rotation8(d_re0, d_im0))
    sec = psk8_sector_stream(d_re, d_im)
    sec0 = psk8_sector_stream(d_re0, d_im0)
    res1 = psk8_sync_and_pack_rotations(sec, pattern, pattern2)

    def _fallback():
        res2 = psk8_sync_and_pack_rotations(sec0, pattern, pattern2)

        def _plain():
            packed, n_valid = pack_bits_from(_psk8_gray_bits(sec0), jnp.int32(0))
            return packed, n_valid, jnp.asarray(False)

        return jax.lax.cond(res2[2], lambda: res2, _plain)

    return jax.lax.cond(res1[2], lambda: res1, _fallback)


def psk8_real_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """D8PSK receive chain: tribits -> magic-aligned bytes."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _psk8_bytes_cfo(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2,
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.partial(jax.jit, static_argnames=("baud", "carrier", "sample_rate"))
def _psk8_bytes_nosync(samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int):
    """D8PSK no-sync rescue front end: the derotated sector stream packed
    from offset 0 under ALL 8 rotation relabelings (the byte-level rescue
    sweep has no sector knowledge, so every hypothesis ships as its own
    stream — the D8PSK analog of :func:`_psk_bytes_nosync`)."""
    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation8(d_re, d_im))
    sec = psk8_sector_stream(d_re, d_im)
    out = []
    for k in range(8):
        st = ((sec.astype(jnp.int32) + (8 - k)) % 8).astype(jnp.uint8)
        out.append(pack_bits_from(_psk8_gray_bits(st), jnp.int32(0)))
    return out


def psk8_nosync_streams(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int
) -> list:
    """Host wrapper for :func:`_psk8_bytes_nosync`: 8 full byte streams."""
    pairs = _psk8_bytes_nosync(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(samp_rate)
    )
    return [bytes(np.asarray(p)[: int(n)]) for p, n in pairs]


def _tracked_phase(
    re_f: jnp.ndarray, im_f: jnp.ndarray, n_psk: int, window: int
) -> jnp.ndarray:
    """Viterbi&Viterbi carrier phase track: per-symbol reference θ̂(n).

    Differential detection pays a noisy-reference penalty (measured 2.35 dB
    at 8PSK — PERF.md "D8PSK sensitivity decomposition",
    benchmarks/psk8_bound_results.json; classically ~2.3 dB at DQPSK and
    ~1 dB at DBPSK) because its phase reference is ONE noisy symbol. The
    wire formats are differential only in their ENCODING, so a receiver
    that rebuilds a clean carrier reference and makes ABSOLUTE sector
    decisions (differentially decoded afterwards) reaches the coherent
    bound.

    Three data-free stages, all elementwise/cumsum (no trellis despite the
    estimator's name), at the data-cancelling power P (z² for DBPSK's
    half-turn alphabet, z⁴ for DQPSK's quarter-turns, z⁸ for D8PSK):

    1. **Ramp removal** — residual CFO appears as a common angular rate; the
       mean rate of the P-th-power phasors, ω̂ₚ = arg Σ uₚ[n]·conj(uₚ[n−1]),
       is derotated out so the windowed average stays coherent under offsets
       up to ~baud/(2P) Hz.
    2. **Windowed average** — box filter of the energy-weighted |z|²e^{jPθ}
       phasors over ``window`` symbols (centered): √window noise reduction
       on the phase reference vs the single-symbol differential reference.
    3. **Unwrap** — arg(·)/P is ambiguous mod 2π/P; per-symbol deltas of the
       ×P phase are wrapped to (−π, π] and re-accumulated so the reference
       follows drift continuously. A slip costs ONE differential symbol (the
       absolute-decision/differential-decode structure localizes it), which
       is why decisions stay differential rather than absolute-to-preamble.

    Returns θ̂ (n,) float32 — subtract from the symbol phasors before sector
    decisions. The reference framework has no tracking receiver anywhere
    (its receivers sample one baseband point per symbol,
    /root/reference/modem.py:137-266).
    """
    if n_psk == 8:
        ur, ui = _eighth_power(re_f, im_f)
    elif n_psk == 4:
        ur, ui = _fourth_power(re_f, im_f)
    else:
        # z² is already |z|²·e^{j2θ} — the right energy weight, no division.
        ur = re_f * re_f - im_f * im_f
        ui = 2.0 * re_f * im_f
    cr = ur[1:] * ur[:-1] + ui[1:] * ui[:-1]
    ci = ui[1:] * ur[:-1] - ur[1:] * ui[:-1]
    om = jnp.arctan2(jnp.sum(ci), jnp.sum(cr))  # rad/symbol in the ×P domain
    n = re_f.shape[0]
    # The naive ramp om*arange(n) is unbounded: at ~1e6 rad (a few hundred-k
    # symbols of nonzero ω̂) float32 resolution is ~0.1 rad and the
    # derotation decoheres. Build the ramp pre-wrapped via a two-level index
    # split (idx = q·4096 + r) with every intermediate wrapped mod 2π·P — a
    # whole number of turns, so cos/sin below are unchanged and the returned
    # θ̂ = (thu+ph)/P only shifts by whole 2π turns. Worst-case intermediate
    # is ~5e4 rad (float32 res ~4e-3 rad in the ×P domain → ~5e-4 rad on θ̂).
    wrap = 2.0 * jnp.pi * float(n_psk)
    idx = jnp.arange(n, dtype=jnp.int32)
    om_hi = jnp.mod(om * 4096.0, wrap)
    ph = jnp.mod(
        jnp.mod(om_hi * (idx // 4096).astype(jnp.float32), wrap)
        + om * (idx % 4096).astype(jnp.float32),
        wrap,
    )
    c, s = jnp.cos(ph), jnp.sin(ph)
    vr = ur * c + ui * s
    vi = ui * c - ur * s
    # Streams shorter than the window (e.g. a probe or an alias capture at
    # a high chip rate): jnp.convolve('same') returns max(len, window)
    # elements, breaking the thu+ph add below — clamp to the stream.
    window = max(1, min(int(window), int(n)))
    k = jnp.ones((window,), jnp.float32)
    mr = jnp.convolve(vr, k, mode="same", precision=matmul_precision())
    mi = jnp.convolve(vi, k, mode="same", precision=matmul_precision())
    thp = jnp.arctan2(mi, mr)
    d = thp[1:] - thp[:-1]
    d = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
    thu = jnp.concatenate([thp[:1], thp[0] + jnp.cumsum(d)])
    return (thu + ph) / float(n_psk)


def _tracked_derotate(
    re_f: jnp.ndarray, im_f: jnp.ndarray, n_psk: int, window: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Symbol phasors rotated by −θ̂(n) from :func:`_tracked_phase`."""
    th = _tracked_phase(re_f, im_f, n_psk, window)
    c, s = jnp.cos(th), jnp.sin(th)
    return re_f * c + im_f * s, im_f * c - re_f * s


def psk8_tracked_sectors(
    re_f: jnp.ndarray, im_f: jnp.ndarray, window: int = 128
) -> jnp.ndarray:
    """Coherent D8PSK sector deltas from RAW symbol phasors (n−1,) uint8.

    Absolute k·π/4 sector decisions against the tracked carrier reference
    (:func:`_tracked_phase`), then differential decode in sector space —
    drop-in for the differential-detection stream feeding
    :func:`psk8_sync_and_pack_rotations` (deltas are invariant to the
    tracker's constant k·π/4 ambiguity, so hypothesis k=0 matches)."""
    wr, wi = _tracked_derotate(re_f, im_f, 8, window)
    k_abs = psk8_sector_stream(wr, wi).astype(jnp.int32)
    return ((k_abs[1:] - k_abs[:-1]) % 8).astype(jnp.uint8)


def qpsk_tracked_gray_streams(
    re_f: jnp.ndarray, im_f: jnp.ndarray, window: int = 128
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coherent DQPSK Gray dibit streams from RAW symbol phasors.

    Absolute quarter-turn decisions against the tracked reference, delta in
    sector space, Gray relabel (00→0, 01→+90°, 11→180°, 10→−90° — the wire
    map, reference modem.py:171-200). Drop-in for the hi/lo streams feeding
    :func:`ops.common.dibit_sync_and_pack_rotations`; the tracker's constant
    k·π/2 ambiguity cancels in the delta, so hypothesis k=0 matches."""
    wr, wi = _tracked_derotate(re_f, im_f, 4, window)
    horiz = jnp.abs(wr) >= jnp.abs(wi)
    k_abs = jnp.where(
        horiz,
        jnp.where(wr >= 0, 0, 2),
        jnp.where(wi >= 0, 1, 3),
    ).astype(jnp.int32)
    d = (k_abs[1:] - k_abs[:-1]) % 4
    g = d ^ (d >> 1)
    return ((g >> 1) & 1).astype(jnp.uint8), (g & 1).astype(jnp.uint8)


def bpsk_tracked_bits(
    re_f: jnp.ndarray, im_f: jnp.ndarray, window: int = 128
) -> jnp.ndarray:
    """Coherent DBPSK bit stream from RAW symbol phasors (n−1,) uint8.

    The z² tracker's residual ambiguity is k·π — a constant antipodal flip
    that cancels in the XOR delta, so the stream needs no relabeling
    hypotheses at all (unlike the differential path's 4 quarter-turn
    candidates)."""
    wr, _ = _tracked_derotate(re_f, im_f, 2, window)
    k_abs = (wr < 0).astype(jnp.uint8)
    return k_abs[1:] ^ k_abs[:-1]


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "sample_rate", "pattern", "pattern2", "window"),
)
def _psk8_bytes_tracked(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    pattern: str, pattern2: str = "", window: int = 128,
):
    """Coherent-tracked D8PSK demod to bytes: raw-phasor front end (shared
    pass 1/2 with the differential path), V&V tracked sectors, rotation
    sync + pack."""
    re_f, im_f, _ = psk_symbol_streams(samples, baud, carrier, sample_rate, n_psk=8)
    sec = psk8_tracked_sectors(re_f, im_f, window)
    return psk8_sync_and_pack_rotations(sec, pattern, pattern2)


def psk8_tracked_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0,
    samp_rate: int = 96000, window: int = 128,
) -> bytes:
    """Coherent-tracked D8PSK receive: ~2.35 dB more sensitive than
    :func:`psk8_real_demodulate`'s differential detection (the measured
    noisy-reference penalty) at ~2× the front-end cost (the raw projection
    is re-run). The mode ladder escalates to this when the differential
    pass finds no frame (modem._psk8_mode_demodulate)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _psk8_bytes_tracked(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.partial(
    jax.jit,
    static_argnames=(
        "baud", "carrier", "sample_rate", "n_psk", "pattern", "pattern2", "window",
    ),
)
def _psk_bytes_tracked(
    samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int,
    n_psk: int, pattern: str, pattern2: str = "", window: int = 128,
):
    """Coherent-tracked DBPSK/DQPSK demod to bytes: raw-phasor front end
    (shared pass 1/2 with the differential path), V&V tracked decisions,
    magic sync + pack. DBPSK's z² tracker leaves only an antipodal
    ambiguity that the XOR delta cancels, so its sync is a single validated
    pattern find; DQPSK reuses the 4-hypothesis dibit sync (k=0 matches)."""
    from .common import (
        dibit_sync_and_pack_rotations,
        find_bit_pattern_validated,
        pack_bits_from,
    )

    re_f, im_f, _ = psk_symbol_streams(samples, baud, carrier, sample_rate, n_psk=4)
    if n_psk == 2:
        bits = bpsk_tracked_bits(re_f, im_f, window)
        start, found = find_bit_pattern_validated(bits, pattern, pattern2)
        packed, n_valid = pack_bits_from(bits, start)
        return packed, n_valid, found
    hi, lo = qpsk_tracked_gray_streams(re_f, im_f, window)
    return dibit_sync_and_pack_rotations(hi, lo, pattern, pattern2)


def qpsk_tracked_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0,
    samp_rate: int = 96000, window: int = 128,
) -> bytes:
    """Coherent-tracked DQPSK receive — recovers the differential-detection
    penalty (~2.3 dB at the 1e-3 waterfall) at ~2× front-end cost; the mode
    ladder escalates here when the differential pass yields no valid frame
    (modem._psk_mode_demodulate)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _psk_bytes_tracked(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), 4, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


def bpsk_tracked_demodulate(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0,
    samp_rate: int = 96000, window: int = 128,
) -> bytes:
    """Coherent-tracked DBPSK receive (~1 dB over differential detection)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _psk_bytes_tracked(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(samp_rate), 2, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.partial(jax.jit, static_argnames=("baud", "carrier", "sample_rate"))
def _psk8_soft_core(samples: jnp.ndarray, baud: float, carrier: float, sample_rate: int):
    """Derotated D8PSK differential phasors -> per-sector scores (n, 8)."""
    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation8(d_re, d_im))
    dirs = jnp.stack(
        [jnp.asarray(_ET_COS, jnp.float32), jnp.asarray(_ET_SIN, jnp.float32)]
    )  # (2, 8)
    return jnp.matmul(jnp.stack([d_re, d_im], axis=1), dirs, precision=matmul_precision())  # (n, 8)


def psk8_soft_bits_rotations(
    samples: np.ndarray, baud: float, carrier: float, samp_rate: int
) -> list:
    """D8PSK soft Gray tribit streams under ALL 8 π/4-rotation hypotheses.

    Per symbol, the per-sector score is the projection of the differential
    phasor onto each k·π/4 direction; each Gray bit's soft value is the
    max-log LLR — max score over sectors labeling the bit 1 minus max over
    sectors labeling it 0 — mapped to [0,1]. A channel rotation of k·π/4
    relabels RECEIVED sector r as transmitted r−k, which on the score matrix
    is a column permutation, so all 8 hypotheses come from ONE device pass.
    (The rotation relabel is nonlinear on Gray bits — unlike DQPSK's
    quarter-turn shuffle — which is why the producer enumerates hypotheses
    instead of the consumer.) Element 0 is the k=0 stream for stream-FEC.
    """
    scores = np.asarray(_psk8_soft_core(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier), int(samp_rate)
    ))  # (n, 8) — column t = score of TRANSMITTED sector t under k=0
    n = scores.shape[0]
    # Gray label of each transmitted sector, split into 3 bit lanes.
    g = _GRAY8.astype(np.int64)
    bit_is_one = np.stack([(g >> 2) & 1, (g >> 1) & 1, g & 1]).astype(bool)  # (3, 8)
    out = []
    for k in range(8):
        # Under hypothesis k, transmitted sector t was received as (t+k)%8.
        s_k = scores[:, (np.arange(8) + k) % 8]  # (n, 8) indexed by t
        scale = np.mean(np.abs(s_k)) * 2.0 + 1e-9
        soft = np.empty(3 * n, np.float32)
        for j in range(3):
            llr = np.max(s_k[:, bit_is_one[j]], axis=1) - np.max(
                s_k[:, ~bit_is_one[j]], axis=1
            )
            soft[j::3] = np.clip(0.5 + llr / scale, 0.0, 1.0)
        out.append(soft)
    return out


@functools.lru_cache(maxsize=1)
def _psk8_pack_weights() -> np.ndarray:
    """(3, 128, 48) banded byte-pack template for tribit symbol rows.

    128 symbols = 384 bits = exactly 48 bytes, so a symbol-aligned row packs
    with NO cross-row spill: W[q, t, n] = 2^(7-j) when Gray bit ``q`` of
    symbol ``t`` lands at bit ``j`` of byte ``n`` (3t+q == 8n+j). Packing is
    then one einsum against the three Gray planes — the (m, 3) stack +
    reshape of the vmapped path is a strided relayout of the stream, and
    the dynamic bit-stream shift of
    ``pack_bits_from`` costs two more full passes.
    """
    W = np.zeros((3, 128, 48), np.float32)
    for t in range(128):
        for q in range(3):
            i = 3 * t + q
            W[q, t, i // 8] = float(1 << (7 - (i % 8)))
    return W


@jax.jit
def psk8_relabel_pack_batch(
    sec: jnp.ndarray, ksel: jnp.ndarray, idx: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Relabel + byte-pack D8PSK sector streams on the winning hypothesis.

    ``sec`` (B, m) received sectors (m % 128 == 0), ``ksel`` (B,) the
    rotation hypothesis, ``idx`` (B,) the match start in SYMBOLS. True
    sector = received − k (mod 8); the stream is shifted by ``idx mod 8``
    symbols only — 3·8 = 24 bits per 8 symbols, so the magic then sits at
    the WHOLE byte 3·(idx//8), which the frame parsers' magic scan absorbs
    The per-capture shift is 8 static slices selected by mask instead of a
    take_along_axis gather. Gray bit planes come out elementwise and one banded
    einsum packs bytes. Returns ``(packed (B, m//128*48) uint8,
    n_valid (B,))``.
    """
    b, m = sec.shape
    true = (sec.astype(jnp.int32) + (8 - ksel.astype(jnp.int32))[:, None]) & 7
    r8 = idx.astype(jnp.int32) % 8
    xp = jnp.pad(true, ((0, 0), (0, 8)))  # zero tail: garbage beyond n_valid
    shifted = xp[:, :m]
    for k in range(1, 8):
        shifted = jnp.where(r8[:, None] == k, xp[:, k : k + m], shifted)
    g = shifted ^ (shifted >> 1)
    planes = jnp.stack([(g >> 2) & 1, (g >> 1) & 1, g & 1]).astype(jnp.float32)
    rows = planes.reshape(3, b, m // 128, 128)
    W = jnp.asarray(_psk8_pack_weights())
    out = jnp.einsum(
        "qbrt,qtn->brn", rows, W, preferred_element_type=jnp.float32, precision=matmul_precision()
    )
    packed = out.reshape(b, (m // 128) * 48).astype(jnp.uint8)
    n_valid = (3 * (jnp.int32(m) - r8)) // 8
    return packed, n_valid
