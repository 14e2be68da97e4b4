"""NEURAL mode: learned-codebook modulation as a first-class wire mode.

The reference gestures at ML-assisted modulation with a torch file that
contains no network (/root/reference/neural_modem.py); its mode recommender
nonetheless knows a "NEURAL" profile. Here NEURAL is a real mode: the
committed codebook (trained by models/train_neural.py — an autoencoder over
an AWGN channel) maps each byte to a 16-dimensional unit-power codeword of
8 complex baseband chips, which ride a 24 kHz carrier.

Array-first design: modulation is a gather + one matmul against the carrier
basis; demodulation is downconversion (elementwise), per-chip box integration
(a reshape + mean), and ONE ``(n_sym, 16) @ (16, 256)`` matmul + argmax —
maximum-likelihood nearest-codeword detection (all codewords have equal norm,
so correlation argmax == Euclidean argmin, and detection is scale-invariant).
Frame sync is a matched-filter correlation against the known 32-symbol
preamble waveform via FFT, yielding both timing and carrier phase.

Wire format: [32-symbol preamble | framed bytes, 1 byte = 1 symbol]. At
``symbol_rate`` symbols/s the payload rate is ``symbol_rate`` bytes/s —
faster than every classical mode here at equal baud.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .common import matmul_precision

SAMPLE_RATE = 96000
CARRIER = 24000.0  # fs/4: the double-frequency image alternates sign per
# sample, so box integration over an even-length chip cancels it exactly.
CHIPS_PER_SYMBOL = 8
PREAMBLE_LEN = 32

_CODEBOOK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "models", "data", "neural_codebook.npz"
)


@functools.lru_cache(maxsize=1)
def _codebook() -> np.ndarray:
    """(256, 16) float32 learned codebook: [I(0..7) | Q(0..7)] per symbol."""
    if os.path.exists(_CODEBOOK_PATH):
        with np.load(_CODEBOOK_PATH) as z:
            cb = np.asarray(z["codebook"], np.float32)
    else:
        # Zip-safe load (zipapp / wheel-in-zip): read via importlib.resources.
        import io
        from importlib import resources

        blob = (
            resources.files("audio_modem_radio.models")
            .joinpath("data/neural_codebook.npz")
            .read_bytes()
        )
        with np.load(io.BytesIO(blob)) as z:
            cb = np.asarray(z["codebook"], np.float32)
    assert cb.shape == (256, 2 * CHIPS_PER_SYMBOL), cb.shape
    return cb


@functools.lru_cache(maxsize=1)
def _preamble_symbols() -> np.ndarray:
    """Fixed pseudo-random preamble symbols (part of the wire format)."""
    return np.random.default_rng(0xFBFC).integers(0, 256, PREAMBLE_LEN, dtype=np.uint8)


def _chip_len(symbol_rate: int) -> int:
    """Samples per chip; even so the fs/2 image cancels under box integration."""
    raw = max(2, round(SAMPLE_RATE / (symbol_rate * CHIPS_PER_SYMBOL)))
    return raw + (raw % 2)


def _bucket(n: int) -> int:
    b = 256
    while b < n:
        b <<= 1
    return b


def _synth(symbols, codebook, chip_len: int) -> np.ndarray:
    """(n_sym,) byte symbols -> real waveform (n_sym * 8 * chip_len,).

    Pure numpy: modulation is not a hot path, and host synthesis keeps
    transmit free of device traffic.
    """
    cw = np.asarray(codebook)[np.asarray(symbols)]  # (n, 16)
    i_chips = cw[:, :CHIPS_PER_SYMBOL].reshape(-1)
    q_chips = cw[:, CHIPS_PER_SYMBOL:].reshape(-1)
    i_t = np.repeat(i_chips, chip_len)
    q_t = np.repeat(q_chips, chip_len)
    n = np.arange(i_t.shape[0], dtype=np.float64)
    w = 2 * np.pi * (CARRIER / SAMPLE_RATE) * n
    return (i_t * np.cos(w) - q_t * np.sin(w)).astype(np.float32)


def neural_mode_modulate(
    framed: bytes, symbol_rate: int = 1200, samp_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """framed bytes -> NEURAL waveform (float32, peak 0.9)."""
    assert samp_rate == SAMPLE_RATE, "NEURAL mode is defined at 96 kHz"
    chip_len = _chip_len(symbol_rate)
    symbols = np.concatenate(
        [_preamble_symbols(), np.frombuffer(framed, np.uint8)]
    ).astype(np.int32)
    n_sym = len(symbols)
    padded = np.pad(symbols, (0, _bucket(n_sym) - n_sym))
    wave = _synth(padded, _codebook(), chip_len)  # host-only: no device traffic
    wave = wave[: n_sym * CHIPS_PER_SYMBOL * chip_len]
    peak = float(np.max(np.abs(wave))) or 1.0
    return (wave * (0.9 / peak)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _preamble_baseband(chip_len: int) -> np.ndarray:
    """Complex baseband template of the preamble (chips zero-order-held)."""
    cw = _codebook()[_preamble_symbols()]
    chips = (cw[:, :CHIPS_PER_SYMBOL] + 1j * cw[:, CHIPS_PER_SYMBOL:]).reshape(-1)
    return np.repeat(chips, chip_len).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _preamble_spectra(chip_len: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-cached rfft spectra of the preamble baseband's (re, im) parts."""
    pre = _preamble_baseband(chip_len)
    return (
        np.fft.rfft(pre.real, n_fft).astype(np.complex64),
        np.fft.rfft(pre.imag, n_fft).astype(np.complex64),
    )


@functools.partial(jax.jit, static_argnames=("chip_len", "n_fft"))
def _demod(
    x: jnp.ndarray,
    codebook: jnp.ndarray,
    pre_fr: jnp.ndarray,
    pre_fi: jnp.ndarray,
    chip_len: int,
    n_fft: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Padded samples -> (symbols per position, correlation peak index).

    ALL-REAL streams: every array stays real except the rfft/irfft
    spectra:

    * CARRIER = fs/4, so the downconversion oscillator is the 4-periodic
      pattern cos = [1,0,-1,0], sin = [0,1,0,-1] — sign masks, no trig.
    * The matched-filter correlation C[k] = sum_i z[k+i]*conj(p[i]) splits
      into four REAL cross-correlations, batched as two irffts:
      Re C = xc(zr,pr) + xc(zi,pi), Im C = xc(zi,pr) - xc(zr,pi), with
      xc(a,b) = irfft(rfft(a)*conj(rfft_b)) and the preamble spectra
      precomputed on the host (``_preamble_spectra``).
    * Alignment is concat + dynamic-slice on the real components (dynamic
      roll on complex64 was itself an UNIMPLEMENTED op), and the phase
      unrotation is the explicit 2x2 real rotation.
    """
    n = x.shape[0]
    osc = jnp.tile(jnp.asarray([1.0, 0.0, -1.0, 0.0], jnp.float32), -(-n // 4))[:n]
    zr = x * osc
    zi = x * jnp.tile(jnp.asarray([0.0, -1.0, 0.0, 1.0], jnp.float32), -(-n // 4))[:n]

    fr = jnp.fft.rfft(zr, n_fft)
    fi = jnp.fft.rfft(zi, n_fft)
    corr_re = jnp.fft.irfft(fr * jnp.conj(pre_fr) + fi * jnp.conj(pre_fi), n_fft)[:n]
    corr_im = jnp.fft.irfft(fi * jnp.conj(pre_fr) - fr * jnp.conj(pre_fi), n_fft)[:n]
    mag2 = corr_re * corr_re + corr_im * corr_im
    k0 = jnp.argmax(mag2)
    norm = jnp.sqrt(mag2[k0]) + 1e-12
    ph_re, ph_im = corr_re[k0] / norm, corr_im[k0] / norm

    def _rot(v):
        doubled = jnp.concatenate([v, v])
        return jax.lax.dynamic_slice(doubled, (k0,), (v.shape[0],))

    zr, zi = _rot(zr), _rot(zi)
    # z * conj(phase): the explicit real rotation.
    zr, zi = zr * ph_re + zi * ph_im, zi * ph_re - zr * ph_im

    spsym = CHIPS_PER_SYMBOL * chip_len
    max_sym = n // spsym
    chips_r = zr[: max_sym * spsym].reshape(max_sym, CHIPS_PER_SYMBOL, chip_len).mean(-1)
    chips_i = zi[: max_sym * spsym].reshape(max_sym, CHIPS_PER_SYMBOL, chip_len).mean(-1)
    rx = jnp.concatenate([chips_r, chips_i], axis=-1)  # (max_sym, 16)
    scores = jnp.matmul(rx, codebook.T, precision=matmul_precision())  # ML nearest-codeword
    return jnp.argmax(scores, axis=-1).astype(jnp.uint8), k0


@functools.lru_cache(maxsize=8)
def _corr_table(chip_len: int) -> np.ndarray:
    """(128+P, 256) time-domain correlation weights, P = preamble samples.

    Column l < 128 holds the preamble REAL part at lag l, column 128+l the
    IMAG part: one ``(rows, 128+P) @ (128+P, 256)`` matmul yields 128
    correlation lags per row for both components. Replaces the four
    full-capture rfft/irfft passes of the FFT matched filter:
    cross-correlation with a 512-tap template is matmul work, not FFT work.
    """
    pre = _preamble_baseband(chip_len)
    P = len(pre)
    T = np.zeros((128 + P, 256), np.float32)
    for l in range(128):
        T[l : l + P, l] = pre.real
        T[l : l + P, 128 + l] = pre.imag
    return T


@functools.lru_cache(maxsize=8)
def _codebook_blocked(chip_len: int) -> np.ndarray:
    """(256//chip_len, (16//chip_len)*256) block-diagonal codebook scorer.

    A chip row is [re chips | im chips] for 128 samples (128//chip_len
    chips each, (16//chip_len) symbols). Lane ``m*256 + w`` of the output
    scores symbol slot m against codeword w — ML detection for a whole row
    of symbols in one aligned matmul, instead of an (n_sym, 16) score
    layout per symbol.
    """
    cb = _codebook()  # (256, 16)
    cpr = 128 // chip_len  # chips per row per component
    spr = cpr // CHIPS_PER_SYMBOL  # symbols per row
    W = np.zeros((2 * cpr, spr * 256), np.float32)
    for m in range(spr):
        for c in range(CHIPS_PER_SYMBOL):
            W[m * CHIPS_PER_SYMBOL + c, m * 256 : (m + 1) * 256] = cb[:, c]
            W[cpr + m * CHIPS_PER_SYMBOL + c, m * 256 : (m + 1) * 256] = cb[:, CHIPS_PER_SYMBOL + c]
    return W


def _chip_shift_table(chip_len: int, guard: jnp.ndarray) -> jnp.ndarray:
    """(128, 512, 256//chip_len) per-offset chip-averaging projections.

    Entry s maps a 256-sample overlapped row pair [zr | zi] (512 lanes) to
    [re chips | im chips] at sample offset s: the box average of chip c is
    lanes ``[s + c*chip_len, s + (c+1)*chip_len)``. Selecting by the traced
    ``k0 % 128`` is an aligned leading-dim index — with the aligned
    ``k0 // 128`` tile slice it replaces the misaligned full-stream
    dynamic-slice rotation (the OFDM lesson). Built in-graph from iota behind a
    traced ``guard`` (== 1) so XLA cannot constant-fold the ~8-32 MB table
    into the executable; build OUTSIDE any vmap.
    """
    cpr = 128 // chip_len
    s = jax.lax.broadcasted_iota(jnp.int32, (128, 256, cpr), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (128, 256, cpr), 1)
    c = jax.lax.broadcasted_iota(jnp.int32, (128, 256, cpr), 2)
    hit = ((j >= s + c * chip_len) & (j < s + (c + 1) * chip_len)).astype(jnp.float32)
    T = hit * (guard / chip_len)  # (128, 256, cpr)
    z = jnp.zeros_like(T)
    # block-diagonal over the [zr | zi] row pair -> [re chips | im chips]
    return jnp.concatenate(
        [jnp.concatenate([T, z], axis=1), jnp.concatenate([z, T], axis=1)], axis=2
    )


def _td_supported(chip_len: int) -> bool:
    """Gate for the time-domain fast path (table sizes stay sane)."""
    return 128 % (CHIPS_PER_SYMBOL * chip_len) == 0 and chip_len <= 4


@functools.lru_cache(maxsize=8)
def _energy_table(P: int) -> np.ndarray:
    """(128+P, 128) banded ones: sliding window energy at every in-row lag
    as one matmul on the correlation row layout."""
    T = np.zeros((128 + P, 128), np.float32)
    for l in range(128):
        T[l : l + P, l] = 1.0
    return T


@functools.lru_cache(maxsize=8)
def _preamble_energy(chip_len: int) -> float:
    pre = _preamble_baseband(chip_len)
    return float(np.sum(np.abs(pre) ** 2))


# Prefix-sync accept threshold on the normalized correlation peak
# rho = |corr|^2 / (E_pre * E_window). Cauchy-Schwarz bounds rho <= 1; a
# clean capture measures ~0.5 (the conjugate-image term of real-passband
# downconversion without low-pass halves the matched energy) and pure noise
# ~1/P ~ 0.002 (tests/test_neural_mode.py pins both). 0.12 escalates below
# roughly -5 dB SNR — where a full-lag search is warranted anyway.
TD_PREFIX_RHO = 0.12


def demod_td_batch(samples: jnp.ndarray, chip_len: int) -> jnp.ndarray:
    """(B, N) -> (B, n_sym) uint8 symbols: batched TD demod, prefix sync.

    The preamble opens every transmission, so the matched filter searches
    lags only in the first ~1/8 of each capture first and accepts iff EVERY
    capture's normalized peak clears ``TD_PREFIX_RHO``; the escalation
    ``lax.cond`` sits OUTSIDE the capture vmap (a vmapped cond executes
    both branches, which would erase the saving — the PSK sync tails'
    all-capture consensus structure). Late transmissions or silence
    escalate to the full-lag search. One deliberate difference from the
    global argmax: when two transmissions share a capture and both pass the
    threshold, the prefix peak (the FIRST preamble) wins — previously the
    stronger one did.

    Symbol extraction is :func:`_td_extract` vmapped over the captures.
    """
    chip_tab = _chip_shift_table(chip_len, 1.0 + 0.0 * samples[0, 0])
    cb_b = jnp.asarray(_codebook_blocked(chip_len))
    corr_t = jnp.asarray(_corr_table(chip_len))
    P = corr_t.shape[0] - 128
    e_tab = jnp.asarray(_energy_table(P))
    e_pre = _preamble_energy(chip_len)
    nb = P // 128

    b, n = samples.shape
    n_pad = -(-n // 128) * 128
    r3 = n_pad // 128
    r_pre = max(1, r3 // 8)
    def prefix_peak(a, b_):
        cre, cim = _td_corr(a, b_, corr_t, r_pre)
        k0, pr, pi, pk = _td_peak(cre, cim)
        e2 = jnp.matmul(  # (r_pre, 128)
            _td_corr_rows(a * a + b_ * b_, r_pre, nb), e_tab, precision=matmul_precision()
        )
        ew = e2.reshape(-1)[k0]
        rho = pk / (e_pre * ew + 1e-12)
        return k0, pr, pi, rho

    def full_peak(a, b_):
        cre, cim = _td_corr(a, b_, corr_t, r3)
        k0, pr, pi, _pk = _td_peak(cre, cim)
        return k0, pr, pi

    zr, zi = jax.vmap(_td_prep)(samples)

    if 2 * r_pre <= r3:
        k0p, prp, pip, rho = jax.vmap(prefix_peak)(zr, zi)
        hit = jnp.all(rho >= TD_PREFIX_RHO)
        k0, pr, pi = jax.lax.cond(
            hit, lambda: (k0p, prp, pip), lambda: jax.vmap(full_peak)(zr, zi)
        )
    else:
        k0, pr, pi = jax.vmap(full_peak)(zr, zi)

    return jax.vmap(
        lambda a, b_, k, cr, ci: _td_extract(a, b_, k, cr, ci, cb_b, chip_tab)
    )(zr, zi, k0, pr, pi)


def _td_prep(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """fs/4 downconversion by sign masks (no trig, all-real); pads to the
    128-lane tile."""
    pad = (-x.shape[0]) % 128
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), jnp.float32)])
    n = x.shape[0]
    zr = x * jnp.tile(jnp.asarray([1.0, 0.0, -1.0, 0.0], jnp.float32), -(-n // 4))[:n]
    zi = x * jnp.tile(jnp.asarray([0.0, -1.0, 0.0, 1.0], jnp.float32), -(-n // 4))[:n]
    return zr, zi


def _td_corr_rows(z: jnp.ndarray, rows: int, nb: int) -> jnp.ndarray:
    """(rows, 128*(nb+1)) overlapped correlation rows for lags [0, rows*128).

    Lag l needs samples l .. l+P; slicing real samples (prefix search) and
    zero-padding (full search past the capture end) are both just 'take
    (rows+nb+1)*128 samples, padding with zeros if short'."""
    need = (rows + nb + 1) * 128
    if need > z.shape[0]:
        z = jnp.concatenate([z, jnp.zeros((need - z.shape[0],), jnp.float32)])
    z2 = z[:need].reshape(rows + nb + 1, 128)
    return jnp.concatenate([z2[t : rows + t] for t in range(nb + 1)], axis=1)


def _td_corr(
    zr: jnp.ndarray, zi: jnp.ndarray, corr_table: jnp.ndarray, rows: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Preamble matched filter over lags [0, rows*128): ONE blocked matmul."""
    nb = (corr_table.shape[0] - 128) // 128
    rr = jnp.concatenate(
        [_td_corr_rows(zr, rows, nb), _td_corr_rows(zi, rows, nb)], axis=0
    )  # (2*rows, 128+P)
    UV = jnp.matmul(rr, corr_table, precision=matmul_precision())  # (2*rows, 256)
    U, V = UV[:rows], UV[rows:]
    corr_re = (U[:, :128] + V[:, 128:]).reshape(-1)
    corr_im = (V[:, :128] - U[:, 128:]).reshape(-1)
    return corr_re, corr_im


def _td_peak(
    corr_re: jnp.ndarray, corr_im: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """argmax lag, unit channel phasor and peak |corr|^2."""
    mag2 = corr_re * corr_re + corr_im * corr_im
    k0 = jnp.argmax(mag2)
    norm = jnp.sqrt(mag2[k0]) + 1e-12
    return k0, corr_re[k0] / norm, corr_im[k0] / norm, mag2[k0]


def _td_extract(
    zr: jnp.ndarray,
    zi: jnp.ndarray,
    k0: jnp.ndarray,
    ph_re: jnp.ndarray,
    ph_im: jnp.ndarray,
    codebook_blocked: jnp.ndarray,
    chip_table: jnp.ndarray,
) -> jnp.ndarray:
    """Chips at k0 via aligned tile slice + offset-table projection, then
    block-diagonal codebook scoring."""
    r3 = zr.shape[0] // 128
    q, s = k0 // 128, k0 % 128
    tiles = jnp.concatenate([zr.reshape(r3, 128), zi.reshape(r3, 128)], axis=1)
    tiles2 = jnp.concatenate([tiles, tiles], axis=0)  # circular, like _rot
    t = jax.lax.dynamic_slice(tiles2, (q, 0), (r3 + 1, 256))
    rows = jnp.concatenate(  # (r3, 512): two-tile window per component
        [t[:-1, :128], t[1:, :128], t[:-1, 128:], t[1:, 128:]], axis=1
    )
    # reorder to [zr tile pair | zi tile pair] = (r3, 512) @ (512, 2*cpr)
    # (r3, 2*cpr): [re chips | im chips]
    chips = jnp.matmul(rows, chip_table[s], precision=matmul_precision())
    cpr = chips.shape[1] // 2
    cr, ci = chips[:, :cpr], chips[:, cpr:]
    # z * conj(phase), applied on chip tiles (commutes with the box mean).
    cr, ci = cr * ph_re + ci * ph_im, ci * ph_re - cr * ph_im
    scores = jnp.matmul(
        jnp.concatenate([cr, ci], axis=1), codebook_blocked, precision=matmul_precision()
    )
    spr = scores.shape[1] // 256
    return jnp.argmax(scores.reshape(r3 * spr, 256), axis=-1).astype(jnp.uint8)


def _demod_td(
    x: jnp.ndarray,
    codebook_blocked: jnp.ndarray,
    corr_table: jnp.ndarray,
    chip_table: jnp.ndarray,
    chip_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-matmul NEURAL demod: (padded samples) -> (symbols, k0).

    Same math as :func:`_demod` (the FFT formulation, kept as the fallback
    for chip lengths the tables don't cover) restructured as matmuls:

    1. fs/4 downconversion by sign masks (no trig, all-real).
    2. Preamble matched filter as a blocked cross-correlation matmul
       (``_corr_table``); argmax lag = k0, peak phasor = channel phase.
    3. Chip extraction at k0 via aligned tile slice + per-offset projection
       table (``_chip_shift_table``); the capture is tile-doubled first so
       the wrap semantics match the FFT path's circular roll.
    4. Channel-phase unrotation on the (rows, chips) tiles (commutes with
       the box average), then one block-diagonal codebook matmul + argmax
       per 256-lane group (``_codebook_blocked``).

    Tables are built/selected OUTSIDE any vmap. Arbitrary input lengths are
    zero-padded up to the 128-lane tile (extra tail symbols decode to
    garbage the frame parser ignores, exactly like the bucket padding).
    The batched path (parallel/batch.py) composes the same phases with a
    prefix-limited sync search and all-capture consensus escalation.
    """
    zr, zi = _td_prep(x)
    r3 = zr.shape[0] // 128
    corr_re, corr_im = _td_corr(zr, zi, corr_table, r3)
    k0, ph_re, ph_im, _pk = _td_peak(corr_re, corr_im)
    sym = _td_extract(zr, zi, k0, ph_re, ph_im, codebook_blocked, chip_table)
    return sym, k0


@functools.partial(jax.jit, static_argnames=("chip_len",))
def _demod_td_jit(x: jnp.ndarray, chip_len: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-capture entry for :func:`_demod_td` (tables built in-trace)."""
    tab = _chip_shift_table(chip_len, 1.0 + 0.0 * x[0])
    return _demod_td(
        x,
        jnp.asarray(_codebook_blocked(chip_len)),
        jnp.asarray(_corr_table(chip_len)),
        tab,
        chip_len,
    )


def _demod_np(
    x: np.ndarray, codebook: np.ndarray, pre_bb: np.ndarray, chip_len: int, n_fft: int
) -> np.ndarray:
    """Host (numpy) mirror of :func:`_demod` — same math, same results."""
    n = np.arange(len(x), dtype=np.float64)
    z = x * np.exp(-2j * np.pi * (CARRIER / SAMPLE_RATE) * n)
    corr = np.fft.ifft(np.fft.fft(z, n_fft) * np.conj(np.fft.fft(pre_bb, n_fft)))[: len(x)]
    k0 = int(np.argmax(np.abs(corr)))
    phase = corr[k0] / (abs(corr[k0]) + 1e-12)
    z = np.roll(z, -k0) * np.conj(phase)
    spsym = CHIPS_PER_SYMBOL * chip_len
    max_sym = len(x) // spsym
    chips = z[: max_sym * spsym].reshape(max_sym, CHIPS_PER_SYMBOL, chip_len).mean(-1)
    rx = np.concatenate([chips.real, chips.imag], axis=-1)
    return np.argmax(rx @ codebook.T, axis=-1).astype(np.uint8)


def neural_mode_demodulate(
    samples: np.ndarray, symbol_rate: int = 1200, samp_rate: int = SAMPLE_RATE
) -> bytes:
    """NEURAL waveform -> byte stream (preamble stripped; parser finds FBPC).

    Runs the jitted all-real demod on whatever backend JAX has (see
    :func:`_demod`). ``_demod_np`` remains as the
    test oracle only.
    """
    assert samp_rate == SAMPLE_RATE, "NEURAL mode is defined at 96 kHz"
    chip_len = _chip_len(symbol_rate)
    spsym = CHIPS_PER_SYMBOL * chip_len
    x = np.asarray(samples, np.float32)
    if len(x) < (PREAMBLE_LEN + 1) * spsym:
        return b""
    n_pad = _bucket(len(x))
    x = np.pad(x, (0, n_pad - len(x)))
    if _td_supported(chip_len):
        symbols, _k0 = _demod_td_jit(jnp.asarray(x), chip_len)
        return bytes(np.asarray(symbols)[PREAMBLE_LEN:])
    n_fft = 1 << int(np.ceil(np.log2(n_pad + PREAMBLE_LEN * spsym)))
    pre_fr, pre_fi = _preamble_spectra(chip_len, n_fft)
    symbols, _k0 = _demod(
        jnp.asarray(x),
        jnp.asarray(_codebook()),
        jnp.asarray(pre_fr),
        jnp.asarray(pre_fi),
        chip_len,
        n_fft,
    )
    return bytes(np.asarray(symbols)[PREAMBLE_LEN:])
