"""Continuous-phase FSK: array-native modulation and demodulation.

Wire-compatible with the reference CPFSK definition
(/root/reference/modem.py:270-341): ``0xAA AA AA AA`` byte preamble, MSB-first
bits, one sine tone per bit (mark=1, space=0) with a running phase accumulator
for spectral continuity, output scaled by 0.9, and magic-pattern byte
alignment on receive.

Array-first architecture:

* **Modulation** — the per-bit starting phase is accumulated on the host in
  exact integer units of ``1/sample_rate`` cycles (tone frequencies are
  integers, so ``freq*samples_per_bit mod sample_rate`` is exact — no float
  drift across millions of bits, unlike a float accumulator). The waveform is
  one ``(n_bits, 4) @ (4, samples_per_bit)`` matmul: each bit contributes
  ``(cosφ, sinφ)`` against precomputed (sin, cos) basis rows of its tone.
* **Demodulation** — three strategies, chosen statically from the tone
  separation (cycles per bit window), all in the blocked lanes-major layout
  (bit index on the 128-lane axis, row = spr*spb lanes; see ARCHITECTURE.md):

  - *Raw-sample LS subspace detector* (separation >= 0.8, e.g. FSK1200, MSK,
    FT8): per-bit least-squares projection onto the joint 4-D
    {mark, space} x {sin, cos} subspace via one block-diagonal matmul — no
    FFT anywhere; the Gram inverse separates the tones and their
    negative-frequency images exactly.
  - *Analytic matched filter* (0.4 <= separation < 0.8, e.g. FSK19200): the
    analytic transform removes the negative-frequency image, after which
    plain quadrature correlation is the noise-optimal noncoherent detector
    (the raw-sample dual basis is ill-conditioned here and amplifies noise).
  - *Frequency discriminator* (separation < 0.4, e.g. the reference's
    FSK9600 configuration: 1200/2200 Hz tones at 9600 baud — which crashes
    the reference demodulator outright because its bandpass edge goes
    negative): band-limited analytic signal, per-sample phasor products,
    per-bit *vector* frequency averages via a boxcar matmul (one atan2 per
    bit), then a statically calibrated linear ISI equalizer.

  All three are strictly stronger receivers than the reference's
  Butterworth-envelope comparison (modem.py:306-315).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .common import (
    _analytic_fir_taps,
    analytic_bandpass,
    analytic_bandpass_fir,
    analytic_bandpass_fir_dec,
    analytic_fir_dec_rows,
    bit_sync_and_pack,
    bytes_to_bits,
    matmul_precision,
)

# FIR front-end length for the analytic-signal paths (overlap-save blocked
# FFTs instead of one whole-capture FFT).
_FIR_TAPS = 1025

# Tap count for the decimating matmul FIR front end (one matmul, no FFT;
# ops.common.analytic_bandpass_fir_dec). The row geometry caps the overlap at
# taps - dec <= 128*dec; within that, SHORTER is faster: the dense template
# costs 2*(128*dec + taps - dec) MACs per output, so at dec=4 cutting
# 513 -> 129 taps removes ~38% of the front-end FLOPs. Measured BER-neutral
# on FSK9600 across 9/12/15 dB AWGN (3 seeds, ~300 kbit/cell) with a 0
# clean-signal floor: the wider ~4 kHz transition skirts admit negligible
# extra noise relative to the ~12 kHz pass band, and their deterministic
# leakage is absorbed by the equalizer calibration (fir_taps keys the
# calibration cache, so the equalizer always matches the front end). 129 is
# always odd -> integral group delay.
def _mm_taps(dec: int) -> int:
    return min(129, 128 * dec + 1)

FSK_PREAMBLE = b"\xAA\xAA\xAA\xAA"

# Block-parallel MLSE geometry: Viterbi blocks of CORE bits with OVERLAP-bit
# warmup/cooldown on each side (survivor merge depth is a few hundred bits).
_MLSE_BLOCK_CORE = 1 << 13
_MLSE_BLOCK_OVERLAP = 1 << 10


def _samples_per_bit(sample_rate: int, baud: float) -> int:
    # round(), matching the reference (modem.py:272).
    return int(round(sample_rate / baud))


@functools.lru_cache(maxsize=64)
def _tone_basis(spb: int, mark: float, space: float, sample_rate: int) -> np.ndarray:
    """(4, spb): rows = sin/cos of mark tone, sin/cos of space tone."""
    t = np.arange(spb, dtype=np.float64) / sample_rate
    wm, ws = 2 * np.pi * mark * t, 2 * np.pi * space * t
    return np.stack([np.sin(wm), np.cos(wm), np.sin(ws), np.cos(ws)]).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("spb", "mark", "space", "sample_rate"))
def _synthesize(coeff: jnp.ndarray, spb: int, mark: float, space: float, sample_rate: int) -> jnp.ndarray:
    """(n_bits, 4) coefficient rows -> waveform (n_bits*spb,), scaled by 0.9."""
    basis = jnp.asarray(_tone_basis(spb, mark, space, sample_rate))
    return jnp.matmul(coeff, basis, precision=matmul_precision()).reshape(-1) * jnp.float32(0.9)


def fsk_modulate(
    data_bytes: bytes,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
) -> np.ndarray:
    """CPFSK with exact continuous phase across bit boundaries.

    A one-byte ``0xAA`` postamble is appended after the payload: the receive
    chain's spectral front end has an edge transient at end-of-signal, and the
    postamble keeps it off the final payload bit. Frame parsers (ours and the
    reference's) ignore bytes past the frame payload, so this is transparent
    on the wire.
    """
    spb = _samples_per_bit(samp_rate, baud)
    bits = bytes_to_bits(FSK_PREAMBLE + data_bytes + b"\xAA").astype(np.int64)

    # Phase advance per bit in integer 1/samp_rate-cycle units (exact for
    # integer tone frequencies; non-integer ones fall back to rounding, which
    # deviates by < 0.5 sample-cycle per bit).
    inc_mark = int(round(mark_freq * spb)) % samp_rate
    inc_space = int(round(space_freq * spb)) % samp_rate
    incs = np.where(bits == 1, inc_mark, inc_space)
    phase_units = np.concatenate([[0], np.cumsum(incs[:-1])]) % samp_rate
    phi = 2 * np.pi * phase_units / samp_rate

    cphi, sphi = np.cos(phi), np.sin(phi)
    is_mark = bits == 1
    # sin(w_tone*t + phi) = sin(w t)cos(phi) + cos(w t)sin(phi), routed to the
    # tone selected by the bit.
    coeff = np.stack(
        [cphi * is_mark, sphi * is_mark, cphi * ~is_mark, sphi * ~is_mark], axis=1
    ).astype(np.float32)
    from .psk import _bucket_symbols

    n_bits = coeff.shape[0]
    coeff = np.pad(coeff, ((0, _bucket_symbols(n_bits) - n_bits), (0, 0)))
    out = _synthesize(jnp.asarray(coeff), spb, float(mark_freq), float(space_freq), int(samp_rate))
    return np.asarray(out)[: n_bits * spb]


# --- demodulation -------------------------------------------------------------

def _separation_cycles(baud: float, mark: float, space: float, sample_rate: int) -> float:
    return abs(mark - space) * _samples_per_bit(sample_rate, baud) / sample_rate


# --- blocked receive geometry ---------------------------------------------

def _fsk_geometry(spb: int) -> Tuple[int, int, int]:
    """(symbols_per_row, row_lanes, overlap_lanes) for the blocked layout.

    row_lanes = spr*spb must be a multiple of 128 (lane alignment) and is
    sized near 1024+ lanes; the overlap covers a window shifted up to one
    full bit into the next row.
    """
    unit = 128 // math.gcd(spb, 128)
    spr = unit * max(1, -(-1024 // (unit * spb)))
    row = spr * spb
    # The last bit in a row starts at (spr-1)*spb + offset (< spb), so its
    # window extends at most spb-1 lanes past the row end; ov <= row always.
    ov = 128 * (-(-spb // 128))
    return spr, row, ov


@functools.lru_cache(maxsize=64)
def _fsk_blocked_templates(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) block-diagonal tone-quadrature templates.

    Columns per row-chunk: [mark_sin x spr | mark_cos x spr | space_sin x spr
    | space_cos x spr]; bit s's window occupies rows [s*spb+o, s*spb+o+spb).
    Noncoherent energies need no phase convention, so tones use global time.
    """
    spr, row, ov = _fsk_geometry(spb)
    t = np.arange(row + ov, dtype=np.float64) / sample_rate
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            # Least-squares dual of the joint 4-D tone subspace: raw (real)
            # correlation alone suffers negative-frequency image interference
            # when a bit holds <1 tone cycle; the Gram inverse separates the
            # tones (and their images) exactly on clean signals.
            B = np.stack(
                [
                    np.sin(2 * np.pi * mark * t[sl]),
                    np.cos(2 * np.pi * mark * t[sl]),
                    np.sin(2 * np.pi * space * t[sl]),
                    np.cos(2 * np.pi * space * t[sl]),
                ],
                axis=1,
            )  # (spb, 4)
            G = B.T @ B + 1e-6 * np.eye(4)
            D = B @ np.linalg.inv(G)  # (spb, 4) dual basis
            W[i, sl, s] = D[:, 0]
            W[i, sl, spr + s] = D[:, 1]
            W[i, sl, 2 * spr + s] = D[:, 2]
            W[i, sl, 3 * spr + s] = D[:, 3]
    return W


@functools.lru_cache(maxsize=64)
def _fsk_quadrature_templates(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) plain tone quadratures [cos_m, sin_m,
    cos_s, sin_s] for matched filtering of the ANALYTIC signal (no dual
    basis: the analytic transform already removed the negative-frequency
    image, and plain correlation is the noise-optimal detector)."""
    spr, row, ov = _fsk_geometry(spb)
    t = np.arange(row + ov, dtype=np.float64) / sample_rate
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            W[i, sl, s] = np.cos(2 * np.pi * mark * t[sl])
            W[i, sl, spr + s] = np.sin(2 * np.pi * mark * t[sl])
            W[i, sl, 2 * spr + s] = np.cos(2 * np.pi * space * t[sl])
            W[i, sl, 3 * spr + s] = np.sin(2 * np.pi * space * t[sl])
    return W


@functools.lru_cache(maxsize=64)
def _fsk_local_quadrature_templates(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) LOCAL-time tone quadratures for MLSE.

    MLSE needs each bit's correlation phase referenced to the bit's own start
    (matching the modulator's per-bit phase accumulator), so the cos/sin
    arguments restart at every bit window. Columns per row-chunk:
    [cos_m x spr | sin_m x spr | cos_s x spr | sin_s x spr].
    """
    spr, row, ov = _fsk_geometry(spb)
    tl = np.arange(spb, dtype=np.float64) / sample_rate  # local time
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            W[i, sl, s] = np.cos(2 * np.pi * mark * tl)
            W[i, sl, spr + s] = np.sin(2 * np.pi * mark * tl)
            W[i, sl, 2 * spr + s] = np.cos(2 * np.pi * space * tl)
            W[i, sl, 3 * spr + s] = np.sin(2 * np.pi * space * tl)
    return W


def _cpfsk_trellis(spb: int, mark: float, space: float, sample_rate: int):
    """(n_states, adv_mark, adv_space) for the CPFSK phase trellis, or None.

    Per-bit phase advances are exact rationals (integer 1/sr-cycle units);
    the state is the accumulated phase on their common grid.
    """
    inc_m = int(round(mark * spb)) % sample_rate
    inc_s = int(round(space * spb)) % sample_rate
    g = math.gcd(math.gcd(inc_m, inc_s), sample_rate)
    n_states = sample_rate // g
    if n_states > 96 or n_states < 2:
        return None
    return n_states, (inc_m // g) % n_states, (inc_s // g) % n_states


def _mlse_refine(
    s_corr, c_corr, eq_bits, n_states: int, adv_mark: int, adv_space: int,
    spb: int, mark: float, space: float, sample_rate: int,
):
    """Maximum-likelihood sequence detection over the CPFSK phase trellis.

    Operates on RAW-sample correlations: on a clean (or white-noise) channel
    the received bit IS the hypothesis waveform ``a·sin(2π f_b t + φ_s)``, so
    the ML branch metric is ``-||x - a·h||² ∝ m(s,b) - (a/2)·||h_{s,b}||²``
    with ``m = S_b cosφ_s + C_b sinφ_s``. Both correction pieces matter and
    were measured to matter:

    * The energy term ``||h||² = spb/2 - (cos2φ·Kc - sin2φ·Ks)/2`` varies
      strongly with the hypothesis phase over short windows — correlation-only
      metrics (valid only for equal-energy hypotheses) lose to the linear
      equalizer here.
    * Band-limited (analytic) front-end correlations also fail: the filter
      smears each bit across neighbors, so ideal-waveform hypotheses no
      longer match. Raw samples ARE the model.

    ``s_corr/c_corr``: (2, n_bits) per-bit local-time Σx·sin / Σx·cos per
    tone, rows [mark, space]. ``eq_bits`` seed the decision-directed channel
    phase and amplitude estimates. Returns refined bits.
    """
    n_bits = s_corr.shape[1]
    phases_np = 2 * np.pi * np.arange(n_states) / n_states
    sin_t = jnp.asarray(np.sin(phases_np).astype(np.float32))
    cos_t = jnp.asarray(np.cos(phases_np).astype(np.float32))
    tl = np.arange(spb) / sample_rate
    kc = np.float32([np.cos(4 * np.pi * f * tl).sum() for f in (mark, space)])
    ks = np.float32([np.sin(4 * np.pi * f * tl).sum() for f in (mark, space)])

    # Channel-phase estimate. Key facts: (a) the trellis is invariant under
    # rotations by whole grid steps (2π/n_states) — rotating every state
    # relabels paths without changing their bits or metrics — so θ only
    # matters modulo one grid step; (b) every true symbol phase is ON the
    # grid, so (u_k)^n_states erases the per-bit phase entirely. Hence
    # θ̂ = angle(Σ_k w_k·e^{j·n_states·ψ_k}) / n_states with ψ = angle(u):
    # needs NO phase trajectory, so seed bit errors (which would rotate a
    # cumulative trajectory and poison a decision-directed estimate — the
    # round-1 failure mode) cannot corrupt it.
    # The quadrature correlation of a pure tone bit is elliptical, exactly:
    # u = j·Σ x e^{-jwt} = (a/2)·(spb·e^{jψ} − D_f·e^{-jψ}) with
    # ψ = φ_state + θ and the static tone constant D_f = Σ_t e^{-2jw_f t}.
    # Invert the ellipse per bit: v = (A·u + B_f·conj(u)) / (A² − |B_f|²)
    # with A = spb/2, B_f = D_f/2, giving v = a·e^{jψ} exactly — unbiased
    # phase AND amplitude per bit.
    tl2 = np.arange(spb) / sample_rate
    d_consts = [np.exp(-4j * np.pi * f * tl2).sum() for f in (mark, space)]
    a_const = spb / 2.0
    b_re = jnp.asarray(np.float32([d.real / 2 for d in d_consts]))[:, None]
    b_im = jnp.asarray(np.float32([d.imag / 2 for d in d_consts]))[:, None]
    denom = jnp.asarray(
        np.float32([a_const**2 - abs(d / 2) ** 2 for d in d_consts])
    )[:, None]
    # v = (A u + B conj(u)) / denom, complex arithmetic in parts:
    v_re = (a_const * s_corr + b_re * s_corr + b_im * c_corr) / denom
    v_im = (a_const * c_corr + b_im * s_corr - b_re * c_corr) / denom

    is_mark = eq_bits[:n_bits] == 1
    u_re = jnp.where(is_mark, v_re[0], v_re[1])
    u_im = jnp.where(is_mark, v_im[0], v_im[1])
    psi = jnp.arctan2(u_im, u_re)
    mag = jnp.sqrt(u_re**2 + u_im**2)
    # θ matters only modulo a grid step (the trellis is rotation-invariant by
    # whole steps) and true phases are on the grid, so the n_states-th power
    # erases them — no phase trajectory, hence immune to seed bit errors.
    theta = (
        jnp.arctan2(
            jnp.sum(mag * jnp.sin(n_states * psi)),
            jnp.sum(mag * jnp.cos(n_states * psi)),
        )
        / n_states
    )
    ct, st = jnp.cos(theta), jnp.sin(theta)
    # u' = u e^{-j theta} on the RAW correlations (the metric model uses u).
    sp = s_corr * ct + c_corr * st  # Re(u')
    cp = c_corr * ct - s_corr * st  # Im(u')
    # Energy-weighted amplitude (Σm²/Σm), not the plain mean: a capture with
    # a long quiet lead has thousands of near-zero-magnitude noise "bits"
    # whose plain mean drags â far below the true signal amplitude, biasing
    # every branch metric's energy correction (the round-3 chaos sweep's
    # 26768-sample-lead FSK9600 capture: MLSE *added* errors over the
    # equalizer seed until â was estimated this way). Strong bits dominate
    # the weighted mean, so silence dilutes it by at most a few percent.
    a_half = jnp.maximum(
        jnp.sum(mag * mag) / jnp.maximum(jnp.sum(mag), 1e-9), 2e-6
    ) / 2

    # Hypothesis energies at the θ-SHIFTED grid: ||h(φ_s + θ)||² is NOT
    # invariant under grid rotations (its ripple has period π), so the energy
    # table must follow the estimated channel phase for the relabeled true
    # path to score exactly.
    ang2 = 2 * (jnp.asarray(phases_np, jnp.float32)[None, :] + theta)  # (1, S)
    ec = spb / 2 - (
        jnp.cos(ang2) * jnp.asarray(kc)[:, None] - jnp.sin(ang2) * jnp.asarray(ks)[:, None]
    ) / 2  # (2, S)

    p1 = (jnp.arange(n_states) - adv_mark) % n_states  # predecessor via bit 1
    p0 = (jnp.arange(n_states) - adv_space) % n_states

    def viterbi(sp_b, cp_b):
        """(2, L) θ-corrected correlations -> (L,) ML bit path."""

        def step(pm, uk):
            sm, cm, ss, cs = uk
            m1 = sm * cos_t + cm * sin_t - a_half * ec[0]  # at each pred phase
            m0 = ss * cos_t + cs * sin_t - a_half * ec[1]
            cand1 = pm[p1] + m1[p1]
            cand0 = pm[p0] + m0[p0]
            take1 = cand1 > cand0
            pm_new = jnp.where(take1, cand1, cand0)
            return pm_new - pm_new.max(), take1

        pm, decisions = jax.lax.scan(
            step, jnp.zeros(n_states), (sp_b[0], cp_b[0], sp_b[1], cp_b[1])
        )

        def back(state, dec_t):
            bit = dec_t[state]
            pred = jnp.where(
                bit, (state - adv_mark) % n_states, (state - adv_space) % n_states
            )
            return pred, bit.astype(jnp.uint8)

        _, bits_rev = jax.lax.scan(back, jnp.argmax(pm), decisions, reverse=True)
        return bits_rev

    sp_cp = jnp.stack([sp, cp], axis=0)  # (2, 2, n_bits): [s/c, tone, t]
    core, ov = _MLSE_BLOCK_CORE, _MLSE_BLOCK_OVERLAP
    if n_bits <= core + 2 * ov:
        return viterbi(sp_cp[0], sp_cp[1])

    # Block-parallel Viterbi: the sequential scan was gated to 2^18 bits in
    # round 1 (long FSK captures silently skipped MLSE). Survivor paths of
    # this trellis merge within a few hundred bits, so blocks overlapping by
    # ``ov`` on each side decode independently (vmapped — the scan length
    # drops from n_bits to core+2ov) and only the converged cores are kept.
    n_blocks = -(-n_bits // core)
    padded = jnp.pad(sp_cp, ((0, 0), (0, 0), (ov, n_blocks * core - n_bits + ov)))
    blocks = jnp.stack(
        [
            jax.lax.dynamic_slice(
                padded, (0, 0, i * core), (2, 2, core + 2 * ov)
            )
            for i in range(n_blocks)
        ]
    )  # (n_blocks, 2, 2, core+2ov)
    bits_blocks = jax.vmap(lambda b: viterbi(b[0], b[1]))(blocks)
    return bits_blocks[:, ov : ov + core].reshape(-1)[:n_bits]


def _discriminator_decimation(spb: int, band_hi: float, sample_rate: int) -> int:
    """Largest power-of-2 decimation the discriminator geometry allows:
    the band must fit the decimated rate and each bit must keep >= 2
    decimated samples (so the per-bit boxcar still averages something).

    At fractional taps-per-bit (FSK9600 dec=4: 2.5) the boxcar templates use
    overlap-proportional tap weights — hard-rounded windows measured ~40%
    worse relative BER at 15 dB (PERF.md). Going below 2 taps/bit (dec=8 at
    1.25) measured ~70% worse even with fractional weights; the >= 2 rule
    stands. Round-3 re-investigation closed dec=8 for good: the band bound
    here is conservative (the decimated ANALYTIC signal is alias-free up to
    band_hi < sr/dec, so dec=8 can keep the full wide band), and a
    per-alignment-class equalizer (one tap set per bit-window phase mod
    dec/gcd(spb, dec)) drives the clean-signal floor to exactly 0 — but
    noisy BER stays ~75% worse (9.2e-2 vs 5.3e-2 at 15 dB): with only
    ~1.25 phasors per bit the discriminator loses half its noise-averaging
    DOF, which no equalizer can restore. The cheap front-end win was taps
    (see _mm_taps), not deeper decimation."""
    d = 1
    while (
        2 * d <= 8
        and band_hi < sample_rate / (2 * d)
        and 2 * (2 * d) <= spb
    ):
        d *= 2
    return d


def _fsk_geometry_dec(spb: int, dec: int) -> Tuple[int, int, int]:
    """(symbols_per_row, row_lanes, overlap_lanes) on the DECIMATED grid.

    ``row = spr*spb/dec`` decimated samples must be integral and a multiple
    of 128 lanes; ``spb/dec`` may be fractional (bit windows round inside the
    boxcar templates). ``dec=1`` reproduces :func:`_fsk_geometry`.
    """
    g = math.gcd(spb, 128 * dec)
    unit = (128 * dec) // g
    lanes_per_bit = spb / dec
    spr = unit * max(1, math.ceil(1024 / (unit * lanes_per_bit)))
    row = spr * spb // dec
    ov = 128 * max(1, math.ceil(2 * lanes_per_bit / 128))
    return spr, row, ov


# Discriminator per-bit averaging window as (lo, hi) fractions of the bit.
# The FULL bit window measured ~35% lower BER than the historical central
# (0.2, 0.8) core at 12-15 dB on FSK9600 (controlled 6-trial comparison,
# shared noise realizations): the extra boundary phasors carry mostly
# neighbor-bit ISI, which the calibrated equalizer undoes, while their noise
# averaging is free.
_CORE_FRAC = (0.0, 1.0)


def _core_bounds(spb: int) -> Tuple[int, int]:
    lo = int(spb * _CORE_FRAC[0])
    hi = max(lo + 2, int(np.ceil(spb * _CORE_FRAC[1])))
    return lo, hi


def _fsk_boxcar_templates_geom(
    spb: int, n_offsets: int, dec: int, spr: int, row: int, ov: int
) -> np.ndarray:
    """(n_offsets, row+ov, spr) per-bit boxcars on an EXPLICIT decimated-grid
    geometry — shared by :func:`_fsk_boxcar_templates_dec` (the XLA layout)
    and the fused discriminator kernel (which blocks rows differently). Bit
    s's window is weighted by fractional tap overlap; see the cached wrapper
    for the rationale."""
    core_lo, core_hi = _core_bounds(spb)
    W = np.zeros((n_offsets, row + ov, spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            lo = s * spb + o + core_lo
            hi = s * spb + o + core_hi
            a = lo // dec
            b = min(-(-hi // dec), row + ov)
            if b <= a:
                a, b = min(a, row + ov - 1), min(a, row + ov - 1) + 1
            for n in range(a, b):
                ovl = min(hi, (n + 1) * dec) - max(lo, n * dec)
                W[i, n, s] = max(ovl, 0) / dec
            if W[i, a:b, s].sum() == 0:
                W[i, a, s] = 1.0  # degenerate window: keep one tap
    return W


@functools.lru_cache(maxsize=64)
def _fsk_boxcar_templates_dec(spb: int, n_offsets: int, dec: int) -> np.ndarray:
    """(n_offsets, row+ov, spr) per-bit boxcars for the discriminator, on the
    decimated grid. Bit s's window [s*spb+o+core_lo, s*spb+o+core_hi)
    (full-rate samples) maps to decimated taps with FRACTIONAL weights: a tap
    covering full-rate span [n*dec, (n+1)*dec) contributes in proportion to
    its overlap with the bit window. For spb % dec == 0 this is the exact 0/1
    boxcar; at fractional taps-per-bit (FSK9600 dec=4: 2.5) it removes the
    rounding noise that cost ~40% relative BER at 15 dB (PERF.md)."""
    spr, row, ov = _fsk_geometry_dec(spb, dec)
    return _fsk_boxcar_templates_geom(spb, n_offsets, dec, spr, row, ov)


def fsk_blocked_row_shape(
    n_samples: int, baud: float, mark: float, space: float, sample_rate: int
):
    """Host helper: (r, row, ov) for pre-overlapping a capture's rows for
    :func:`fsk_demod_bits`, or None when the config doesn't run the dual-tone
    blocked path (close tones / too short). Rows are ``x[i*row : i*row+row+ov]``
    — build them with cheap numpy slicing and pass a (r, row+ov) array."""
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        return None
    spb = _samples_per_bit(sample_rate, baud)
    n_bits = n_samples // spb
    if n_bits < 2:
        return None
    spr, row, ov = _fsk_geometry(spb)
    return -(-n_bits // spr), row, ov


def _fir_frontend_plan(
    baud: float, mark: float, space: float, sample_rate: int
) -> Tuple[float, float, int, int]:
    """(band_lo, band_hi, dec, taps) of the matmul FIR front end for a
    close/mid-tone config — the ONE place this geometry is defined, shared
    by the device path (:func:`fsk_demod_bits`) and the host pre-shaper
    (:func:`fsk_fir_row_shape`)."""
    spb = _samples_per_bit(sample_rate, baud)
    sep = _separation_cycles(baud, mark, space, sample_rate)
    lo_f, hi_f = min(mark, space), max(mark, space)
    band_lo = max(lo_f - baud, 10.0)
    band_hi = min(hi_f + baud, sample_rate / 2 - 10.0)
    if sep >= 0.4:  # mid separation: analytic image suppression only, dec=1
        return band_lo, band_hi, 1, 129
    dec = _discriminator_decimation(spb, band_hi, sample_rate)
    return band_lo, band_hi, dec, _mm_taps(dec)


def fsk_fir_row_shape(
    n_samples: int, baud: float, mark: float, space: float, sample_rate: int
):
    """Host helper: (r, row=128*dec, ov=taps-dec, lead=(taps-1)//2) for
    pre-shaping the matmul FIR front end's overlapped input windows on
    close/mid-tone configs (FSK9600/FSK19200), or None for dual-tone configs
    (:func:`fsk_blocked_row_shape` covers those) and too-short captures.
    Build rows from ``[zeros(lead), x]`` — row i is
    ``padded[i*row : i*row + row + ov]`` — and pass a (r, row+ov) array to
    :func:`fsk_demod_bits` (``frontend='matmul'``, ``mlse=False`` only: MLSE
    refinement correlates the RAW samples)."""
    if _separation_cycles(baud, mark, space, sample_rate) >= 0.8:
        return None
    spb = _samples_per_bit(sample_rate, baud)
    if n_samples // spb < 2:
        return None
    _lo, _hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    nd_out = -(-n_samples // dec)
    r = -(-nd_out // 128)
    return r, 128 * dec, taps - dec, (taps - 1) // 2


def _rows_with_overlap(x: jnp.ndarray, n_used: int, r: int, row: int, ov: int) -> jnp.ndarray:
    """1-D samples -> (r, row+ov) overlapped lane rows (zero-padded)."""
    x_pad = jnp.pad(x[:n_used], (0, r * row + ov - n_used))
    xr = x_pad[: r * row].reshape(r, row)
    nxt = jnp.concatenate([xr[1:, :ov], x_pad[r * row : r * row + ov][None, :]], axis=0)
    return jnp.concatenate([xr, nxt], axis=1)


_EQ_TAPS = 9  # calibrated discriminator equalizer length (per-bit taps)


def _np_vector_bit_freqs(
    wave: np.ndarray, band_lo: float, band_hi: float, sr: int, spb: int,
    core_lo: int, core_hi: int, n_bits: int, fir_taps: int = 0, dec: int = 1,
) -> np.ndarray:
    """Host-side reference of the discriminator front end, for calibration:
    per-bit frequency = angle of the vector sum of z[n+1]*conj(z[n]) over the
    central bit window (amplitude-weighted frequency averaging).

    ``fir_taps`` > 0 applies the FIR analytic filter (the production front
    end, :func:`analytic_bandpass_fir`'s kernel) instead of the brick-wall
    FFT mask — the equalizer must be calibrated against the exact front end
    it will undo."""
    n = len(wave)
    if fir_taps:
        h = _analytic_fir_taps(band_lo, band_hi, sr, fir_taps)
        c = (fir_taps - 1) // 2
        m = 1 << int(np.ceil(np.log2(n + fir_taps)))
        z = np.fft.ifft(np.fft.fft(wave.astype(np.float64), m) * np.fft.fft(h, m))
        z = z[c : c + n]
    else:
        spec = np.fft.fft(wave.astype(np.float64))
        freqs = np.fft.fftfreq(len(wave), d=1.0 / sr)
        spec *= 2.0 * ((freqs >= band_lo) & (freqs <= band_hi))
        z = np.fft.ifft(spec)
    if dec > 1:
        z = z[::dec]  # exact mirror of analytic_bandpass(decimate=dec)
    p = z[1:] * np.conj(z[:-1])
    out = np.empty(n_bits)
    for k in range(n_bits):
        # Fractional tap weights, the exact mirror of the device boxcar
        # templates (_fsk_boxcar_templates_dec).
        lo = k * spb + core_lo
        hi = k * spb + core_hi
        a = lo // dec
        b = min(-(-hi // dec), len(p))
        if b <= a:
            out[k] = 0.0
            continue
        taps = p[a:b]
        n_idx = np.arange(a, b)
        wgt = (np.minimum(hi, (n_idx + 1) * dec) - np.maximum(lo, n_idx * dec)).clip(0) / dec
        acc = (taps * wgt).sum()
        out[k] = np.angle(acc) * sr / dec / (2 * np.pi) if abs(acc) > 0 else 0.0
    return out


@functools.lru_cache(maxsize=64)
def _discriminator_calibration(
    spb: int, baud: float, mark: float, space: float, sample_rate: int,
    band_lo: float, band_hi: float, fir_taps: int = 0, dec: int = 1,
) -> np.ndarray:
    """Fit a per-bit FIR equalizer mapping measured bit frequencies to tones.

    Close-tone CPFSK (modulation index << 1) suffers inter-symbol interference
    through the analytic transform: a bit's measured frequency is biased by
    its neighbors. This one-time, per-configuration calibration synthesizes a
    known pseudo-random bit sequence, measures it through the exact receive
    front end, and least-squares fits ``_EQ_TAPS`` taps + bias that undo the
    bias. Returns (taps..., bias) as float32.

    Residual floor: ~1.5e-5 BER at the pathological FSK9600 configuration
    (1200/2200 Hz tones at 9600 Bd, modulation index 0.1) — the remaining
    errors are nonlinear ISI a linear equalizer cannot reach (a per-bit DFE
    stage was tried and propagates errors; true MLSE over the CPFSK phase
    trellis is the known fix). Use --fec for large payloads there. The
    reference's own demodulator crashes outright on this configuration.
    """
    from .common import bytes_to_bits

    rng = np.random.default_rng(0xFB9C)
    train = rng.integers(0, 256, 3200, dtype=np.uint8).tobytes()
    bits = bytes_to_bits(FSK_PREAMBLE + train).astype(np.float64)

    # Pure-numpy CPFSK synthesis (identical math to fsk_modulate, kept out of
    # the jit path because this runs during tracing).
    inc = np.where(
        bits == 1, int(round(mark * spb)) % sample_rate, int(round(space * spb)) % sample_rate
    )
    phase0 = np.concatenate([[0], np.cumsum(inc[:-1])]) % sample_rate
    t = np.arange(spb, dtype=np.float64) / sample_rate
    tones = np.where(bits[:, None] == 1, mark, space)
    wave = 0.9 * np.sin(
        2 * np.pi * (tones * t[None, :] + phase0[:, None] / sample_rate)
    ).reshape(-1)
    f_true = np.where(bits == 1, mark, space)
    core_lo, core_hi = _core_bounds(spb)
    means = _np_vector_bit_freqs(
        wave, band_lo, band_hi, sample_rate, spb, core_lo, core_hi, len(bits),
        fir_taps=fir_taps, dec=dec,
    )
    pad = _EQ_TAPS // 2
    fm = np.pad(means, pad, mode="edge")
    A = np.stack(
        [fm[j : j + len(bits)] for j in range(_EQ_TAPS)] + [np.ones(len(bits))], axis=1
    )
    coef, *_ = np.linalg.lstsq(A, f_true, rcond=None)
    return coef.astype(np.float32)


@functools.partial(
    jax.jit,
    static_argnames=("baud", "mark", "space", "sample_rate", "n_offsets"),
)
def fsk_dual_bits_rows_batch(
    x3d: jnp.ndarray,
    baud: float,
    mark: float,
    space: float,
    sample_rate: int,
    n_offsets: int = 8,
) -> jnp.ndarray:
    """Batched dual-tone FSK demod over PRE-OVERLAPPED (B, r, row+ov) rows.

    The batched counterpart of :func:`fsk_demod_bits`'s dual-tone branch for
    host-shaped rows (``host_shape_batch``): pass 1 scores timing offsets on
    3 static row windows, pass 2 projects the whole batch in one einsum.
    Rows may be float32 or integer (cast here; the decisions are
    scale-invariant). Returns uint8 bits (B, r*spr); capture-tail entries
    are pad garbage.
    """
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        raise ValueError("fsk_dual_bits_rows_batch requires a dual-tone config")
    spr, row, ov = _fsk_geometry(spb)
    b, r, c = x3d.shape
    if c != row + ov:
        raise ValueError("pre-shaped dual-tone rows must have row+ov columns")
    W = jnp.asarray(
        _fsk_blocked_templates(spb, float(mark), float(space), sample_rate, n_offsets)
    )

    # Pass 1: offset scoring on up to 3 static row windows per capture.
    wr = min(32, r)
    starts = sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)})
    wins = jnp.concatenate([x3d[:, s : s + wr] for s in starts], axis=1).astype(
        jnp.float32
    )  # (B, nw, row+ov); int16 rows cast here (argmax is scale-invariant)
    W_all = W.transpose(1, 0, 2).reshape(row + ov, -1)
    pj = jnp.matmul(wins, W_all, precision=matmul_precision()).reshape(b, -1, n_offsets, 4, spr)
    em = pj[..., 0, :] ** 2 + pj[..., 1, :] ** 2
    es = pj[..., 2, :] ** 2 + pj[..., 3, :] ** 2
    score = jnp.sum(jnp.abs(em - es), axis=(1, 3))  # (B, K)
    best = jnp.argmax(score, axis=1).astype(jnp.int32)

    xov = x3d.astype(jnp.float32)
    pj2 = jnp.einsum("brc,bck->brk", xov, W[best], precision=matmul_precision()).reshape(
        b, r, 4, spr
    )
    margin = (pj2[:, :, 0] ** 2 + pj2[:, :, 1] ** 2) - (
        pj2[:, :, 2] ** 2 + pj2[:, :, 3] ** 2
    )
    return (margin > 0).astype(jnp.uint8).reshape(b, r * spr)


@functools.partial(
    jax.jit,
    static_argnames=(
        "baud", "mark", "space", "sample_rate", "n_offsets", "mlse", "frontend",
        "want_soft",
    ),
)
def fsk_demod_bits(
    samples: jnp.ndarray,
    baud: float,
    mark: float,
    space: float,
    sample_rate: int,
    n_offsets: int = 8,
    mlse: bool = True,
    frontend: str = "matmul",
    want_soft: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate CPFSK to a bit array; returns ``(bits, best_offset_score)``.

    ``want_soft=True`` returns ``(bits, score, margin)`` instead, where
    ``margin`` is the per-bit SIGNED decision statistic (positive = mark =
    bit 1): mark/space energy difference on the matched-filter paths, the
    equalized-frequency distance difference on the discriminator path
    (pre-MLSE — the trellis emits hard decisions; the equalizer's analog
    margin is the soft information). Feeds the soft-decision FEC ladder
    (decoder._soft_bit_stream -> fec.stream_fec_decode_soft).

    Two statically-chosen strategies, both in the blocked lanes-major layout
    (bit index on the 128-lane axis; see ARCHITECTURE.md):

    * Dual-tone matched filter (tones separated >= 0.4 cycles/bit): per-bit
      mark/space energies via ONE matmul of overlapped sample rows against
      block-diagonal tone-quadrature templates, directly on the raw samples
      (the matched filter IS the band-pass — no FFT anywhere).
    * Frequency discriminator (close tones): band-limited analytic signal,
      per-sample phasor product, per-bit *vector* frequency average via a
      boxcar matmul (one atan2 per bit, not per sample), then the calibrated
      per-config ISI equalizer.

    ``frontend`` selects how the analytic-signal paths compute the decimated
    band-limited analytic signal: ``"matmul"`` (default — one decimating
    complex-FIR matmul, no FFT), ``"fft"`` (whole-capture
    rfft + brick-wall mask + decimated ifft), or ``"fir"`` (full-rate
    overlap-save FIR, kept for A/B history). The ISI equalizer is calibrated
    against the exact front end selected, so decoded bits stay consistent.
    """
    if frontend not in ("matmul", "fft", "fir"):
        raise ValueError(f"unknown frontend {frontend!r}")
    spb = _samples_per_bit(sample_rate, baud)
    spr, row, ov = _fsk_geometry(spb)
    sep = _separation_cycles(baud, mark, space, sample_rate)
    pre_shaped = samples.ndim == 2
    fir_rows = None
    if pre_shaped and sep >= 0.8:
        # (r, row+ov) host-overlapped rows (see fsk_blocked_row_shape):
        # skips the device-side pad+reshape+concat row build, like the PSK
        # host row shaping. Trailing pad bits are garbage the
        # sync/parse stage ignores.
        if samples.shape[1] != row + ov:
            raise ValueError("pre-shaped dual-tone rows must have row+ov columns")
        r = samples.shape[0]
        n_bits = r * spr
        xov = samples.astype(jnp.float32)
    elif pre_shaped:
        # Close/mid-tone configs: the rows are the matmul FIR front end's
        # overlapped input windows (see fsk_fir_row_shape) — bit-equal to the
        # windows analytic_bandpass_fir_dec builds on device from flat input.
        if frontend != "matmul":
            raise ValueError("pre-shaped FIR rows require frontend='matmul'")
        if mlse:
            raise ValueError(
                "pre-shaped FIR rows are incompatible with MLSE refinement "
                "(it correlates the raw samples); pass flat samples"
            )
        _plo, _phi, dec_p, taps_p = _fir_frontend_plan(baud, mark, space, sample_rate)
        if samples.shape[1] != 128 * dec_p + taps_p - dec_p:
            raise ValueError("pre-shaped FIR rows have the wrong column count")
        fir_rows = samples.astype(jnp.float32)
        n_bits = (fir_rows.shape[0] * 128 * dec_p) // spb
        r = -(-n_bits // spr)
    else:
        n = samples.shape[-1]
        n_bits = n // spb
        if n_bits < 2:
            raise ValueError("signal shorter than two bit periods")
        r = -(-n_bits // spr)
        x = samples.astype(jnp.float32)

    if sep >= 0.8:
        # Well-separated tones: raw-sample LS subspace detector (no FFT).
        W = jnp.asarray(
            _fsk_blocked_templates(spb, float(mark), float(space), sample_rate, n_offsets)
        )
        if not pre_shaped:
            xov = _rows_with_overlap(x, n_bits * spb, r, row, ov)

        # Pass 1: offset margins on up to 3 row windows.
        wr = min(32, r)
        starts = sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)})
        wins = jnp.concatenate([xov[s : s + wr] for s in starts], axis=0)
        W_all = W.transpose(1, 0, 2).reshape(row + ov, -1)  # (c, K*4spr)
        pj = jnp.matmul(wins, W_all, precision=matmul_precision()).reshape(
            wins.shape[0], n_offsets, 4, spr
        )
        em = pj[:, :, 0] ** 2 + pj[:, :, 1] ** 2
        es = pj[:, :, 2] ** 2 + pj[:, :, 3] ** 2
        score = jnp.sum(jnp.abs(em - es), axis=(0, 2))
        best = jnp.argmax(score)

        # Pass 2: full-signal energies at the winning offset.
        pj = jnp.matmul(xov, W[best], precision=matmul_precision()).reshape(r, 4, spr)
        margin = (pj[:, 0] ** 2 + pj[:, 1] ** 2) - (pj[:, 2] ** 2 + pj[:, 3] ** 2)
        bits = (margin > 0).astype(jnp.uint8).reshape(-1)
        if want_soft:
            return bits[: max(n_bits, 1)], score[best], margin.reshape(-1)[: max(n_bits, 1)]
        return bits[: max(n_bits, 1)], score[best]

    if sep >= 0.4:
        # Mid separation (e.g. FSK19200: 0.42 cycles/bit): matched filter on
        # the ANALYTIC signal. The raw-sample dual basis is ill-conditioned
        # here and amplifies noise; after the analytic transform removes the
        # negative-frequency image, plain quadrature correlation is the
        # noise-optimal noncoherent detector.
        lo_f, hi_f = min(mark, space), max(mark, space)
        # The dec=1 matmul FIR (129 taps, the row
        # geometry's limit at dec=1) replaces the FFT entirely; its wide
        # ~4 kHz transition skirts are harmless here because the quadrature
        # matched filter downstream IS the tone selector — the analytic
        # transform's only job is suppressing the negative-frequency image.
        b_lo = max(lo_f - baud, 10.0)
        b_hi = min(hi_f + baud, sample_rate / 2 - 10.0)
        if fir_rows is not None:
            zr, zi = analytic_fir_dec_rows(fir_rows, b_lo, b_hi, sample_rate, 1, 129)
        elif frontend == "fir":
            z = analytic_bandpass_fir(x, b_lo, b_hi, sample_rate, taps=_FIR_TAPS)
            zr = jnp.real(z).astype(jnp.float32)
            zi = jnp.imag(z).astype(jnp.float32)
        elif frontend == "matmul":
            zr, zi = analytic_bandpass_fir_dec(x, b_lo, b_hi, sample_rate, 1, taps=129)
        else:
            z = analytic_bandpass(x, b_lo, b_hi, sample_rate)
            zr = jnp.real(z).astype(jnp.float32)
            zi = jnp.imag(z).astype(jnp.float32)
        W = jnp.asarray(
            _fsk_quadrature_templates(spb, float(mark), float(space), sample_rate, n_offsets)
        )
        rr = _rows_with_overlap(zr, n_bits * spb, r, row, ov)
        ri = _rows_with_overlap(zi, n_bits * spb, r, row, ov)

        def energies(m, n_):
            # m/n_: (rows, K?, 4, spr) projections of zr/zi. For tone f:
            # E = (Σzr·cos + Σzi·sin)² + (Σzi·cos − Σzr·sin)².
            c_m, s_m, c_s, s_s = m[..., 0, :], m[..., 1, :], m[..., 2, :], m[..., 3, :]
            ic_m, is_m, ic_s, is_s = n_[..., 0, :], n_[..., 1, :], n_[..., 2, :], n_[..., 3, :]
            e_mark = (c_m + is_m) ** 2 + (ic_m - s_m) ** 2
            e_space = (c_s + is_s) ** 2 + (ic_s - s_s) ** 2
            return e_mark - e_space

        wr = min(32, r)
        starts = sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)})
        W_all = W.transpose(1, 0, 2).reshape(row + ov, -1)
        wins_r = jnp.matmul(
            jnp.concatenate([rr[s : s + wr] for s in starts], axis=0), W_all, precision=matmul_precision()
        )
        wins_i = jnp.matmul(
            jnp.concatenate([ri[s : s + wr] for s in starts], axis=0), W_all, precision=matmul_precision()
        )
        m = wins_r.reshape(-1, n_offsets, 4, spr)
        n_ = wins_i.reshape(-1, n_offsets, 4, spr)
        margin_w = energies(m, n_)  # (rows, K, spr)
        score = jnp.sum(jnp.abs(margin_w), axis=(0, 2))
        best = jnp.argmax(score)

        m = jnp.matmul(rr, W[best], precision=matmul_precision()).reshape(r, 4, spr)
        n_ = jnp.matmul(ri, W[best], precision=matmul_precision()).reshape(r, 4, spr)
        margin = energies(m, n_)  # (r, spr)
        bits = (margin > 0).astype(jnp.uint8).reshape(-1)
        if want_soft:
            return bits[: max(n_bits, 1)], score[best], margin.reshape(-1)[: max(n_bits, 1)]
        return bits[: max(n_bits, 1)], score[best]

    # Discriminator path. The analytic signal is DECIMATED by the largest
    # power of two the band and bit geometry allow (exact — the brick-wall
    # spectrum fits in 1/dec of the FFT, see analytic_bandpass): the inverse
    # FFT, the phasor products, the row shaping and the boxcar matmuls all
    # shrink by dec. Bit windows land on fractional decimated-sample
    # boundaries, which the host-built boxcar templates simply round per bit.
    lo_f, hi_f = min(mark, space), max(mark, space)
    band_lo = max(lo_f - baud, 10.0)
    band_hi = min(hi_f + baud, sample_rate / 2 - 10.0)
    dec = 1 if frontend == "fir" else _discriminator_decimation(spb, band_hi, sample_rate)
    if fir_rows is not None:
        zr, zi = analytic_fir_dec_rows(
            fir_rows, band_lo, band_hi, sample_rate, dec, _mm_taps(dec)
        )
    elif frontend == "fir":
        z = analytic_bandpass_fir(x, band_lo, band_hi, sample_rate, taps=_FIR_TAPS)
        zr, zi = jnp.real(z).astype(jnp.float32), jnp.imag(z).astype(jnp.float32)
    elif frontend == "matmul":
        zr, zi = analytic_bandpass_fir_dec(
            x, band_lo, band_hi, sample_rate, dec, taps=_mm_taps(dec)
        )
    else:
        z = analytic_bandpass(x, band_lo, band_hi, sample_rate, decimate=dec)
        zr, zi = jnp.real(z).astype(jnp.float32), jnp.imag(z).astype(jnp.float32)
    spr_d, row_d, ov_d = _fsk_geometry_dec(spb, dec)
    r_d = -(-n_bits // spr_d)
    # Phasor product p[n] = z[n+1] * conj(z[n]) as two real 1-D streams.
    p_re = jnp.concatenate([zr[1:] * zr[:-1] + zi[1:] * zi[:-1], jnp.zeros((1,))])
    p_im = jnp.concatenate([zi[1:] * zr[:-1] - zr[1:] * zi[:-1], jnp.zeros((1,))])

    Wb = jnp.asarray(_fsk_boxcar_templates_dec(spb, n_offsets, dec))
    n_used_d = min(int(p_re.shape[-1]), -(-(n_bits * spb) // dec))
    pr = _rows_with_overlap(p_re, n_used_d, r_d, row_d, ov_d)
    pi = _rows_with_overlap(p_im, n_used_d, r_d, row_d, ov_d)

    # Pass 1: offset margins on row windows (vector-averaged frequencies).
    wr = min(32, r_d)
    starts = sorted({0, max(0, r_d // 2 - wr // 2), max(0, r_d - wr)})
    mid = (mark + space) / 2.0
    scale = sample_rate / dec / (2 * jnp.pi)
    Wb_all = Wb.transpose(1, 0, 2).reshape(row_d + ov_d, -1)
    wins_r = jnp.matmul(
        jnp.concatenate([pr[s : s + wr] for s in starts], axis=0), Wb_all, precision=matmul_precision()
    )
    wins_i = jnp.matmul(
        jnp.concatenate([pi[s : s + wr] for s in starts], axis=0), Wb_all, precision=matmul_precision()
    )
    f_win = jnp.arctan2(wins_i, wins_r) * scale
    # Energy-weighted, deviation-clamped offset score. The raw Σ|f − mid|
    # is not noise-robust: a window row inside a silent/noise lead yields a
    # RANDOM phasor angle whose |f − mid| can reach ~sr/(2·dec) — 20×+ the
    # genuine tone deviation — so a few lead rows swamped every signal row
    # and the winning offset became a coin toss (round-3 chaos sweep:
    # FSK9600 capture with a 26768-sample lead decoded error-free at the
    # true offset but failed end-to-end). Weight each window frequency by
    # its vector magnitude (quiet noise → negligible weight) and clamp the
    # deviation at the tone half-separation, the largest deviation a genuine
    # bit can produce (loud noise → bounded, offset-unbiased contribution).
    dev = (hi_f - lo_f) / 2.0
    mag_w = jnp.sqrt(wins_r**2 + wins_i**2)
    score = jnp.sum(
        (mag_w * jnp.minimum(jnp.abs(f_win - mid), dev)).reshape(
            -1, n_offsets, spr_d
        ),
        axis=(0, 2),
    )
    best = jnp.argmax(score)

    # Pass 2: full-signal vector frequencies at the winning offset.
    sr_sum = jnp.matmul(pr, Wb[best], precision=matmul_precision())  # (r_d, spr_d)
    si_sum = jnp.matmul(pi, Wb[best], precision=matmul_precision())
    f = (jnp.arctan2(si_sum, sr_sum) * scale).reshape(-1)  # (r_d*spr_d,)

    # Undo neighbor-bit ISI with the statically calibrated per-config
    # equalizer (static 1-D shifts are cheap lane slices).
    coef = _discriminator_calibration(
        spb, float(baud), float(mark), float(space), sample_rate,
        float(band_lo), float(band_hi),
        fir_taps={"fir": _FIR_TAPS, "matmul": _mm_taps(dec), "fft": 0}[frontend],
        dec=dec,
    )
    pad = _EQ_TAPS // 2
    fm = jnp.concatenate([jnp.repeat(f[:1], pad), f, jnp.repeat(f[-1:], pad)])
    eq = jnp.full_like(f, float(coef[-1]))
    for j in range(_EQ_TAPS):
        eq = eq + float(coef[j]) * fm[j : j + f.shape[0]]

    bits = (jnp.abs(eq - mark) < jnp.abs(eq - space)).astype(jnp.uint8)
    bits = bits[: max(n_bits, 1)]
    if want_soft and not mlse:
        # Equalized-frequency margin: how much closer to mark than to space.
        margin_d = (jnp.abs(eq - space) - jnp.abs(eq - mark))[: max(n_bits, 1)]
        return bits, score[best], margin_d

    # MLSE refinement on RAW-sample correlations: the equalizer floors around
    # 1.5e-5 BER at tiny modulation indices; the phase-trellis Viterbi is the
    # exact ML detector there. Long captures run the block-parallel Viterbi
    # (vmapped over overlapping blocks) — no capture-size gate since round 2.
    trellis = _cpfsk_trellis(spb, float(mark), float(space), sample_rate) if mlse else None
    if trellis is not None:
        n_states, adv_m, adv_s = trellis
        Wl = jnp.asarray(
            _fsk_local_quadrature_templates(
                spb, float(mark), float(space), sample_rate, n_offsets
            )
        )
        xov = _rows_with_overlap(x, n_bits * spb, r, row, ov)
        # [C_m, S_m, C_s, S_s]
        pj = jnp.matmul(xov, Wl[best], precision=matmul_precision()).reshape(r, 4, spr)
        s_corr = jnp.stack(
            [pj[:, 1].reshape(-1)[:n_bits], pj[:, 3].reshape(-1)[:n_bits]]
        )
        c_corr = jnp.stack(
            [pj[:, 0].reshape(-1)[:n_bits], pj[:, 2].reshape(-1)[:n_bits]]
        )
        bits = _mlse_refine(
            s_corr, c_corr, bits, n_states, adv_m, adv_s,
            spb, float(mark), float(space), sample_rate,
        )

    if want_soft:
        # Discriminator-family soft stream: SIGNS from the (possibly
        # MLSE-refined) decisions — the equalizer alone runs ~16% BER in the
        # regime the soft ladder targets, which would poison the soft
        # Viterbi — MAGNITUDES from the equalized-frequency margin (the
        # trellis emits hard decisions; |margin| is the per-bit reliability).
        margin_d = (jnp.abs(eq - space) - jnp.abs(eq - mark))[: max(n_bits, 1)]
        signed = jnp.where(bits > 0, jnp.abs(margin_d), -jnp.abs(margin_d))
        return bits, score[best], signed

    return bits, score[best]


def fsk_demodulate(
    samples: np.ndarray,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
) -> bytes:
    """CPFSK receive chain: bits -> magic-aligned bytes.

    Close-tone configs run the MLSE-refined stream first (exact on clean
    captures, where the linear equalizer has a ~1.5e-5 floor); if no valid
    frame parses — e.g. a channel whose phase response breaks the MLSE
    waveform model — the equalizer-only stream is returned instead.
    """
    from ..framing import MAGIC_BIT_PATTERN, parse_frames

    def _run(use_mlse: bool) -> bytes:
        bits, _ = fsk_demod_bits(
            jnp.asarray(samples, jnp.float32),
            float(baud),
            float(mark_freq),
            float(space_freq),
            int(samp_rate),
            mlse=use_mlse,
        )
        packed, n_valid, _found = bit_sync_and_pack(bits, MAGIC_BIT_PATTERN)
        return bytes(np.asarray(packed)[: int(n_valid)])

    raw = _run(True)
    if _separation_cycles(baud, mark_freq, space_freq, samp_rate) < 0.4 and not parse_frames(raw):
        eq_raw = _run(False)
        if parse_frames(eq_raw):
            return eq_raw
    return raw


def fsk_soft_bits(
    samples: np.ndarray,
    baud: float,
    mark: float,
    space: float,
    samp_rate: int,
) -> np.ndarray:
    """Soft bit stream in [0, 1] for the soft-decision FEC escalations.

    Per-bit signed margins from the family's own detector (mark/space energy
    difference, quadrature energy difference, or MLSE signs carrying
    equalizer-margin magnitudes on the close-tone discriminator path — see
    :func:`fsk_demod_bits` ``want_soft``), scaled to the same [0,1]
    convention as :func:`ops.psk.psk_soft_bits`. FSK bits carry no
    rotation/inversion ambiguity, so the consumer sweeps one hypothesis.
    ``mlse=True`` matches the single-capture hard path, so the thresholded
    soft stream bit-agrees with the stream the damaged header was parsed
    from (decoder.recover_payload_fec_soft's search requirement).
    """
    _bits, _score, margin = fsk_demod_bits(
        jnp.asarray(samples, jnp.float32), float(baud), float(mark), float(space),
        int(samp_rate), mlse=True, want_soft=True,
    )
    margin = np.asarray(margin)
    scale = 2.0 * np.mean(np.abs(margin)) + 1e-9
    return np.clip(0.5 + margin / scale, 0.0, 1.0).astype(np.float32)


def fsk_high_speed_modulate(data_bytes: bytes, baud: float = 19200, samp_rate: int = 96000) -> np.ndarray:
    """High-rate FSK: 8/16 kHz tones at 19200 baud (reference modem.py:351-352)."""
    return fsk_modulate(data_bytes, baud, 8000.0, 16000.0, samp_rate)


def fsk_high_speed_demodulate(samples: np.ndarray, baud: float = 19200, samp_rate: int = 96000) -> bytes:
    return fsk_demodulate(samples, baud, 8000.0, 16000.0, samp_rate)
