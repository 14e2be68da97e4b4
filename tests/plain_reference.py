"""Plain numpy references for the batched receive stages.

Written from the wire-format definitions in straightforward numpy (float64
where it computes), independent of the blocked/einsum layouts and vmapped
slice scans under test. Tests compare the production XLA paths against
these.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from audio_modem_radio.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

GRAY_HI = (0, 0, 1, 1)  # QPSK sector -> hi bit
GRAY_LO = (0, 1, 1, 0)  # QPSK sector -> lo bit
GRAY8 = np.array([0, 1, 3, 2, 6, 7, 5, 4], np.uint8)  # 8PSK sector -> tribit
GRAY8_INV = np.argsort(GRAY8).astype(np.uint8)  # tribit -> sector


def bits_of(pattern: str) -> np.ndarray:
    return np.asarray([1 if c == "1" else 0 for c in pattern], np.uint8)


def pack_from(bits: np.ndarray, start: int) -> bytes:
    """``bits[start:]`` MSB-first into whole bytes."""
    tail = np.asarray(bits[start:], np.uint8)
    n = (len(tail) // 8) * 8
    return np.packbits(tail[:n]).tobytes()


def first_validated(
    bits: np.ndarray, exact: np.ndarray, tolerant: np.ndarray, tol: int,
    limit: int, step: int = 1,
) -> Optional[int]:
    """First position p in ``range(0, limit, step)`` where ``bits[p:]``
    starts with ``exact`` and then ``tolerant`` within ``tol`` bit
    mismatches (None when there is none)."""
    n = len(exact) + len(tolerant)
    limit = min(limit, len(bits) - n + 1)
    if limit <= 0:
        return None
    win = np.lib.stride_tricks.sliding_window_view(np.asarray(bits, np.uint8), n)
    win = win[:limit:step]
    ok = np.all(win[:, : len(exact)] == exact, axis=1)
    ok &= np.sum(win[:, len(exact) :] != tolerant, axis=1) <= tol
    hits = np.flatnonzero(ok)
    return int(hits[0]) * step if len(hits) else None


# --- DQPSK / OFDM dibit lanes ----------------------------------------------------

def interleave(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    bits = np.empty(2 * len(hi), np.uint8)
    bits[0::2] = hi
    bits[1::2] = lo
    return bits


def relabel_dibits(hi: np.ndarray, lo: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gray sector s -> s - k (undo a k quarter-turn channel rotation)."""
    hi = np.asarray(hi, np.int64)
    lo = np.asarray(lo, np.int64)
    sector = 2 * hi + (hi ^ lo)
    s2 = (sector - k) % 4
    return (
        np.asarray(GRAY_HI, np.uint8)[s2],
        np.asarray(GRAY_LO, np.uint8)[s2],
    )


def relabel_shift_pack(hi, lo, s: int, k: int) -> bytes:
    """Relabel by ``k``, then bytes of the interleaved stream from bit ``s``."""
    rh, rl = relabel_dibits(hi, lo, k)
    return pack_from(interleave(rh, rl), s)


def rotate_pattern(bits: np.ndarray, k: int) -> np.ndarray:
    """A dibit pattern as received under a k quarter-turn rotation: each
    pattern dibit's Gray sector s shows up as s + k."""
    h, l = relabel_dibits(bits[0::2], bits[1::2], -k)
    return interleave(h, l)


def dibit_sync(
    hi, lo, rotations: bool = True, pattern: str = MAGIC_BIT_PATTERN,
    pattern2: str = MAGIC_BIT_PATTERN2, tol: int = 3,
) -> Tuple[bytes, bool]:
    """(bytes from the first validated magic, found). Hypotheses k = 0..3 in
    order (only k = 0 without ``rotations``): the magic rotated by k,
    searched in the received bits at the earliest bit position of either
    dibit parity; the stream is then relabeled by −k and packed from
    there. No match: k = 0 from bit 0."""
    both = pattern + pattern2
    n_all = len(both) // 2
    n_exact = 2 * (len(pattern) // 2)
    raw = interleave(hi, lo)
    limit = 2 * (len(hi) - (n_all + 1))
    for k in range(4 if rotations else 1):
        pat = rotate_pattern(bits_of(both[: 2 * n_all]), k)
        p = first_validated(raw, pat[:n_exact], pat[n_exact:], tol, limit)
        if p is not None:
            return relabel_shift_pack(hi, lo, p, k), True
    return relabel_shift_pack(hi, lo, 0, 0), False


# --- DBPSK sign-bit lanes --------------------------------------------------------

def bit_sync(
    re_bits, im_bits, rotations: bool = True, pattern: str = MAGIC_BIT_PATTERN,
    pattern2: str = MAGIC_BIT_PATTERN2, tol: int = 3,
) -> Tuple[bytes, bool]:
    """DBPSK analog of :func:`dibit_sync`: hypotheses (re, im, ~re, ~im)."""
    re_bits = np.asarray(re_bits, np.uint8)
    im_bits = np.asarray(im_bits, np.uint8)
    exact, tolerant = bits_of(pattern), bits_of(pattern2)
    streams = [re_bits, im_bits, re_bits ^ 1, im_bits ^ 1]
    for stream in streams[: 4 if rotations else 1]:
        p = first_validated(stream, exact, tolerant, tol, len(stream))
        if p is not None:
            return pack_from(stream, p), True
    return pack_from(re_bits, 0), False


# --- D8PSK sectors ---------------------------------------------------------------

def psk8_gray_bits(sec: np.ndarray) -> np.ndarray:
    g = GRAY8[np.asarray(sec, np.int64) % 8]
    bits = np.empty(3 * len(g), np.uint8)
    bits[0::3] = (g >> 2) & 1
    bits[1::3] = (g >> 1) & 1
    bits[2::3] = g & 1
    return bits


def psk8_sync(
    sec, n_rotations: int = 8, pattern: str = MAGIC_BIT_PATTERN,
    pattern2: str = MAGIC_BIT_PATTERN2, tol: int = 3,
) -> Tuple[bytes, bool]:
    """D8PSK sync at symbol granularity: for rotation k the magic's sectors
    are shifted +k and compared in the received Gray labeling (exact bits,
    then ``tol`` tolerant bits); first k in order wins, bytes relabeled
    (true = received − k) from the match."""
    sec = np.asarray(sec, np.int64)
    both = pattern + pattern2
    n_sym = len(both) // 3
    pat_bits = bits_of(both[: 3 * n_sym]).reshape(n_sym, 3)
    tribits = pat_bits @ np.array([4, 2, 1])
    rx_bits = psk8_gray_bits(sec)
    n_exact = len(pattern)
    for k in range(n_rotations):
        exp = psk8_gray_bits((GRAY8_INV[tribits].astype(np.int64) + k) % 8)
        p = first_validated(
            rx_bits, exp[:n_exact], exp[n_exact:], tol,
            3 * (len(sec) - n_sym + 1), step=3,
        )
        if p is not None:
            return pack_from(psk8_gray_bits(sec - k), p), True
    return pack_from(psk8_gray_bits(sec), 0), False


# --- PSK front end ---------------------------------------------------------------

def psk_symbol_phasors(x: np.ndarray, spsym: int, T_pair: np.ndarray) -> np.ndarray:
    """Per-symbol least-squares phasors: symbol s projects the 2-symbol
    window ``x[s*spsym : s*spsym + 2*spsym]`` (zero past the end) on the
    template pair ``T_pair`` (2*spsym, 2) -> complex (n_sym,)."""
    x = np.asarray(x, np.float64)
    n_sym = -(-len(x) // spsym)
    xp = np.zeros((n_sym + 2) * spsym)
    xp[: len(x)] = x
    out = np.empty(n_sym, np.complex128)
    T = np.asarray(T_pair, np.float64)
    for s in range(n_sym):
        w = xp[s * spsym : s * spsym + 2 * spsym]
        re, im = w @ T
        out[s] = re + 1j * im
    return out


def psk_decisions(
    x: np.ndarray, spsym: int, T_pair: np.ndarray, theta: float, n_psk: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hi, lo, d): differential phasors rotated by −θ and their Gray
    (QPSK) or sign (BPSK) decisions."""
    z = psk_symbol_phasors(x, spsym, T_pair)
    d = z[1:] * np.conj(z[:-1]) * np.exp(-1j * theta)
    if n_psk == 4:
        swap = np.abs(d.imag) > np.abs(d.real)
        neg = np.where(swap, d.imag < 0, d.real < 0)
        hi = neg.astype(np.uint8)
        lo = np.where(swap, ~neg, neg).astype(np.uint8)
    else:
        hi = (d.real < 0).astype(np.uint8)
        lo = (d.imag < 0).astype(np.uint8)
    return hi, lo, d


def psk8_sectors(d: np.ndarray) -> np.ndarray:
    """Nearest k·π/4 sector of each differential phasor."""
    return (np.round(np.angle(d) / (np.pi / 4)).astype(np.int64) % 8).astype(np.uint8)


# --- dual-tone FSK -------------------------------------------------------------------

def fsk_dual_bits(rows: np.ndarray, W: np.ndarray, best: int, spr: int) -> np.ndarray:
    """Per-bit mark-minus-space energy decisions of pre-overlapped rows
    (r, row+ov) against the winning offset's templates W[best] (row+ov,
    4*spr: [C_m | S_m | C_s | S_s]) -> uint8 bits (r*spr,)."""
    rows = np.asarray(rows, np.float64)
    Wb = np.asarray(W[best], np.float64)
    bits = np.empty(rows.shape[0] * spr, np.uint8)
    for i, row in enumerate(rows):
        pj = (row @ Wb).reshape(4, spr)
        margin = pj[0] ** 2 + pj[1] ** 2 - pj[2] ** 2 - pj[3] ** 2
        bits[i * spr : (i + 1) * spr] = margin > 0
    return bits


def fir_decimate(x: np.ndarray, taps: np.ndarray, dec: int) -> np.ndarray:
    """Centre-tap-aligned FIR (``np.convolve``, zero-padded) then keep every
    ``dec``-th output: the plain form of the decimating matmul front end."""
    full = np.convolve(np.asarray(x, np.complex128), np.asarray(taps), mode="full")
    lead = (len(taps) - 1) // 2
    return full[lead : lead + len(x)][::dec]
