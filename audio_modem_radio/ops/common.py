"""Shared DSP primitives for the modem: bit packing, frame sync, spectra.

These are the building blocks of every demodulator in this package. Design
notes (vs the reference implementation they functionally replace):

* Bit/byte conversion is array math (``unpackbits``/matmul) rather than python
  string formatting (/root/reference/modem.py:30,111-133).
* Frame-sync ("find the FBPC magic in the bit stream") is a vectorized
  pattern correlation + argmax instead of ``str.find`` — ``bit_sync_and_pack``
  returns the packed bytes for the first sync hypothesis plus the offset-0
  fallback the reference also applies (modem.py:116-133).
* The analytic band-limited signal (``analytic_bandpass``) replaces the
  reference's Butterworth band-pass -> complex mix -> Butterworth low-pass
  chain (modem.py:73-88) with a single FFT pass: zero out negative
  frequencies and everything outside the pass band. This is a zero-phase
  brick-wall filter — the linear-phase analog of the reference's ``filtfilt``
  use — and it makes the subsequent downconversion exactly image-free, so no
  separate low-pass is needed.

Everything here is shape-static and jit/vmap-friendly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

def matmul_precision() -> str:
    """Precision passed by every matmul and einsum of the modem's DSP.

    ``"highest"`` keeps float32 products in float32 on GPUs whose default
    for f32 operands is TF32 (a 10-bit mantissa), so the decision streams
    match a CPU run. JAX's own ``jax_default_matmul_precision`` setting wins
    when it is set, which lets a caller time another precision with
    ``jax.default_matmul_precision(...)`` (the jit caches key on it).
    """
    return jax.config.jax_default_matmul_precision or "highest"


# MSB-first weights for a byte.
_BYTE_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=np.int32)


# --- host-side bit utilities --------------------------------------------------

def bytes_to_bits(data: bytes) -> np.ndarray:
    """bytes -> uint8 bit array, MSB first (matches the reference bit order)."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8/int bit array (MSB first) -> bytes; truncates trailing partial byte."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n]).tobytes()


# --- device-side sync + packing ----------------------------------------------

@functools.partial(jax.jit, static_argnames=("pattern",))
def find_bit_pattern(bits: jnp.ndarray, pattern: str) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """First index where the literal bit ``pattern`` occurs in ``bits``.

    Returns ``(index, found)``; ``index`` is 0 when not found (the caller's
    fallback is to pack from offset 0, mirroring the reference's behavior).

    Implementation: AND of ``len(pattern)`` shifted equality slices — pure
    elementwise work that XLA fuses, instead of a convolution with a tiny
    kernel.
    """
    L = bits.shape[0] - len(pattern) + 1
    if L <= 0:
        # Capture shorter than the sync pattern (e.g. a truncated DSSS
        # stream after 16x despreading): nothing to find, not a crash.
        return jnp.int32(0), jnp.asarray(False)
    match = jnp.ones((L,), dtype=bool)
    for t, c in enumerate(pattern):
        match &= bits[t : t + L] == (1 if c == "1" else 0)
    first = jnp.argmax(match).astype(jnp.int32)  # first True (ties -> lowest)
    found = match[first]
    return jnp.where(found, first, 0), found


def find_bit_pattern_validated(
    bits: jnp.ndarray, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`find_bit_pattern`, but a position only counts when the bits
    FOLLOWING the exact match also agree with ``pattern2`` within ``tol``
    mismatches — per-position, so a later true match survives an earlier
    false one. Empty ``pattern2`` degrades to the plain finder."""
    if not pattern2:
        return find_bit_pattern(bits, pattern)
    n1 = len(pattern)
    n_all = n1 + len(pattern2)
    L = bits.shape[0] - n_all + 1
    if L <= 0:
        # Too short to hold pattern + the full validation window: validate
        # against the longest pattern2 prefix that DOES fit, with ``tol``
        # scaled proportionally (ceil, min 1), instead of silently accepting
        # fully unvalidated matches — even a short validated prefix keeps
        # most of the ~60x false-accept protection. Only when not a single
        # validation bit fits does this degrade to the plain finder.
        k2 = min(int(bits.shape[0]) - n1, len(pattern2))
        if k2 <= 0:
            return find_bit_pattern(bits, pattern)
        scaled = max(1, -(-tol * k2 // len(pattern2)))
        return find_bit_pattern_validated(bits, pattern, pattern2[:k2], scaled)
    match = jnp.ones((L,), dtype=bool)
    for t, c in enumerate(pattern):
        match &= bits[t : t + L] == (1 if c == "1" else 0)
    miss = jnp.zeros((L,), jnp.int32)
    for j, c in enumerate(pattern2):
        miss = miss + (bits[n1 + j : n1 + j + L] != (1 if c == "1" else 0))
    match &= miss <= tol
    first = jnp.argmax(match).astype(jnp.int32)
    found = match[first]
    return jnp.where(found, first, 0), found


@functools.lru_cache(maxsize=8)
def _pack_matrix(bits_per_byte: int, weights: Tuple[int, ...]) -> np.ndarray:
    """Block-diagonal (128*bits_per_byte, 128) matrix: groups of
    ``bits_per_byte`` consecutive lanes weighted into one byte column."""
    W = np.zeros((128 * bits_per_byte, 128), dtype=np.float32)
    for b in range(128):
        for t, w in enumerate(weights):
            W[b * bits_per_byte + t, b] = w
    return W


def _pack_stream(bits_f32: jnp.ndarray, bits_per_byte: int, weights: Tuple[int, ...]) -> jnp.ndarray:
    """Weighted group-sum of lanes via one block-diagonal matmul.

    A (rows, 128*bpb) @ (128*bpb, 128) matmul instead of an (n, 8) reshape
    or a gather. Sums are < 256 so f32 is exact at any matmul precision.
    """
    group = 128 * bits_per_byte
    n = bits_f32.shape[0]
    r = -(-n // group)
    padded = jnp.pad(bits_f32, (0, r * group - n))
    out = jnp.matmul(
        padded.reshape(r, group),
        jnp.asarray(_pack_matrix(bits_per_byte, weights)),
        precision=matmul_precision(),
    )
    return out.reshape(-1).astype(jnp.uint8)  # (r*128,)


def _shift_left(x: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """``x`` shifted left by dynamic ``k``, zero-filled at the tail.

    ``jnp.roll`` with a traced shift lowers to a while loop plus
    pad/dynamic-update-slice passes; this concat + dynamic-slice form is
    one pass.
    """
    n = x.shape[0]
    doubled = jnp.concatenate([x, jnp.zeros_like(x)])
    return jax.lax.dynamic_slice(doubled, (k,), (n,))


@jax.jit
def pack_bits_from(bits: jnp.ndarray, start: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack ``bits[start:]`` MSB-first into bytes (static output shape).

    Returns ``(packed, n_valid)``; ``packed`` has ``ceil(len(bits)/8)``+pad
    entries and only the first ``n_valid`` are meaningful (the tail is
    zero-filled).
    """
    n_bits = bits.shape[0]
    shifted = _shift_left(bits, start).astype(jnp.float32)
    packed = _pack_stream(shifted, 8, (128, 64, 32, 16, 8, 4, 2, 1))
    n_valid = (n_bits - start) // 8
    return packed, n_valid


def _dibit_match(hi, lo, pat_str: str, n1_dibits: int, tol: int, validated: bool):
    """First even/odd-alignment match of ``pat_str`` in the (hi, lo) dibit
    lanes: the first ``n1_dibits`` dibits must match exactly, the remainder
    within ``tol`` bit mismatches (the validation stage). Returns
    ``(start_bit, found)`` — the shared matcher of the plain and rotated
    dibit syncs, so tolerance/parity fixes cannot diverge between them."""
    m = hi.shape[0]
    pat = [1 if c == "1" else 0 for c in pat_str]
    n_all = len(pat) // 2
    L = m - (n_all + 1)
    # Even alignment (bit index 2k): hi carries pattern[0::2], lo [1::2].
    # Odd alignment (bit index 2k+1): lo carries pattern[0::2] at k, hi
    # carries pattern[1::2] at k+1.
    match_e = jnp.ones((L,), dtype=bool)
    match_o = jnp.ones((L,), dtype=bool)
    miss_e = jnp.zeros((L,), jnp.int32)
    miss_o = jnp.zeros((L,), jnp.int32)
    for t in range(n_all):
        if t < n1_dibits:
            match_e &= (hi[t : t + L] == pat[2 * t]) & (lo[t : t + L] == pat[2 * t + 1])
            match_o &= (lo[t : t + L] == pat[2 * t]) & (hi[t + 1 : t + 1 + L] == pat[2 * t + 1])
        else:
            miss_e = miss_e + (hi[t : t + L] != pat[2 * t]) + (lo[t : t + L] != pat[2 * t + 1])
            miss_o = miss_o + (lo[t : t + L] != pat[2 * t]) + (hi[t + 1 : t + 1 + L] != pat[2 * t + 1])
    if validated:
        match_e &= miss_e <= tol
        match_o &= miss_o <= tol
    ie = jnp.argmax(match_e).astype(jnp.int32)
    io = jnp.argmax(match_o).astype(jnp.int32)
    fe, fo = match_e[ie], match_o[io]
    se, so = 2 * ie, 2 * io + 1
    s = jnp.where(fe & (~fo | (se <= so)), se, jnp.where(fo, so, 0))
    return s, fe | fo


@functools.partial(jax.jit, static_argnames=("pattern", "pattern2", "tol"))
def dibit_sync_and_pack(
    hi: jnp.ndarray, lo: jnp.ndarray, pattern: str,
    pattern2: str = "", tol: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sync + byte-pack a dibit stream given as separate (hi, lo) lanes.

    The interleaved bit stream is ``b[2k] = hi[k], b[2k+1] = lo[k]``; this
    never materializes it (an (n, 2) interleave is a strided relayout of
    the whole stream). The magic search runs as two parity hypotheses over the component
    streams, and bytes are assembled by two weighted group-sum matmuls.
    Returns ``(packed, n_valid, found)``. Optional ``pattern2``/``tol``:
    tolerant follow-up validation per position (see
    dibit_sync_and_pack_rotations) — used so the plain sync accepts the
    same matches as the validated kernels, backend-independent.
    """
    m = hi.shape[0]
    s, found = _dibit_match(
        hi, lo, pattern + pattern2, len(pattern) // 2, tol, bool(pattern2)
    )

    k0 = s >> 1
    parity = (s & 1).astype(bool)
    rh = _shift_left(hi, k0).astype(jnp.float32)
    rl = _shift_left(lo, k0).astype(jnp.float32)
    rh_next = jnp.concatenate([rh[1:], jnp.zeros((1,), jnp.float32)])
    a = jnp.where(parity, rl, rh)  # bits 0,2,4,6 of each byte
    b = jnp.where(parity, rh_next, rl)  # bits 1,3,5,7
    packed = _pack_stream(a, 4, (128, 32, 8, 2)) + _pack_stream(b, 4, (64, 16, 4, 1))
    n_valid = (2 * m - s) // 8
    return packed, n_valid, found


_GRAY_HI = (0, 0, 1, 1)  # sector -> hi bit (sectors 0..3 = 0, π/2, π, 3π/2)
_GRAY_LO = (0, 1, 1, 0)  # sector -> lo bit


def _rotate_dibit_pattern(pattern: str, k: int) -> str:
    """The magic pattern as it appears when every diff sector is shifted +k.

    A residual CFO rotation of k·π/2 relabels each received Gray sector
    s -> (s+k) mod 4. Rather than relabeling the (hi, lo) streams four times,
    transform the PATTERN once on the host: pattern dibit p maps to sector
    invgray(p), shows up as sector invgray(p)+k, i.e. bits gray(invgray(p)+k).
    """
    out = []
    for t in range(0, len(pattern) - 1, 2):
        p_hi, p_lo = int(pattern[t]), int(pattern[t + 1])
        s = 2 * p_hi + (p_hi ^ p_lo)  # inverse Gray map
        s2 = (s + k) % 4
        out.append(f"{_GRAY_HI[s2]}{_GRAY_LO[s2]}")
    return "".join(out)


@functools.partial(jax.jit, static_argnames=("pattern", "pattern2", "tol"))
def dibit_sync_and_pack_rotations(
    hi: jnp.ndarray, lo: jnp.ndarray, pattern: str,
    pattern2: str = "", tol: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sync + pack a dibit stream under the 4 quarter-turn CFO hypotheses.

    Matching runs 4x (against the 4 rotated patterns — cheap boolean slice
    scans); shifting and byte packing (the matmuls, the expensive part) run
    ONCE on the winning rotation's relabeled stream. Preference order is
    k=0 first, so a clean channel takes the unrotated path.

    ``pattern2`` (optional): bits that must FOLLOW the pattern within
    ``tol`` mismatches for a position to count. Without it, the 16-bit x
    8-hypothesis match false-fires ~n/8k times per capture on random data,
    and a false hypothesis relabels the whole stream — the validated match
    keeps the false-accept rate ~60x lower while a true match at decodable
    SNR passes with ~0.999 probability.
    """
    starts, founds = [], []
    for k in range(4):
        pat_k = _rotate_dibit_pattern(pattern + pattern2, k)
        s_k, f_k = _dibit_match(
            hi, lo, pat_k, len(pattern) // 2, tol, bool(pattern2)
        )
        starts.append(s_k)
        founds.append(f_k)

    start4 = jnp.stack(starts)
    found4 = jnp.stack(founds)
    ksel = jnp.argmax(found4)  # first found rotation, else 0
    s = start4[ksel]
    found = found4[ksel]
    packed, n_valid = relabel_shift_pack(hi, lo, s, ksel)
    return packed, n_valid, found


def relabel_shift_pack(
    hi: jnp.ndarray, lo: jnp.ndarray, s: jnp.ndarray, ksel: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Relabel the dibit stream by rotation ``ksel`` (sector -> sector - k),
    shift to bit offset ``s`` and byte-pack: the tail of the rotation sync."""
    m = hi.shape[0]
    # Stay in uint8 until the pack matmuls: the dynamic-slice shifts
    # materialize their output, so shifting f32 (the old order) moved 4-byte
    # streams where 1-byte ones suffice, and XLA fuses the relabel
    # arithmetic and the final cast into the matmul reads.
    sector = 2 * hi + (hi ^ lo)  # inverse Gray, per dibit (uint8, values 0..3)
    s2 = (sector + (4 - ksel).astype(jnp.uint8)) & 3
    rh = (s2 >= 2).astype(jnp.uint8)
    rl = ((s2 == 1) | (s2 == 2)).astype(jnp.uint8)

    k0 = s >> 1
    parity = (s & 1).astype(bool)
    fh = _shift_left(rh, k0)
    fl = _shift_left(rl, k0)
    fh_next = jnp.concatenate([fh[1:], jnp.zeros((1,), jnp.uint8)])
    a = jnp.where(parity, fl, fh).astype(jnp.float32)
    b = jnp.where(parity, fh_next, fl).astype(jnp.float32)
    packed = _pack_stream(a, 4, (128, 32, 8, 2)) + _pack_stream(b, 4, (64, 16, 4, 1))
    n_valid = (2 * m - s) // 8
    return packed, n_valid


@functools.partial(jax.jit, static_argnames=("pattern", "pattern2", "tol"))
def bit_sync_and_pack_rotations(
    bits_re: jnp.ndarray, bits_im: jnp.ndarray, pattern: str,
    pattern2: str = "", tol: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """DBPSK analog of :func:`dibit_sync_and_pack_rotations`.

    The 4 quarter-turn hypotheses for a BPSK diff constellation are: k=0 the
    real-axis bits, k=2 their complement, k=1/k=3 the imag-axis bits and
    their complement. Matching = 2 streams x {pattern, ~pattern}; packing
    runs once on the winner. ``pattern2``/``tol``: tolerant follow-up
    validation, see dibit_sync_and_pack_rotations.
    """
    inv = lambda p: "".join("1" if c == "0" else "0" for c in p)
    cands = []
    for bits, pat, pat2 in (
        (bits_re, pattern, pattern2),
        (bits_im, pattern, pattern2),
        (bits_re, inv(pattern), inv(pattern2)),
        (bits_im, inv(pattern), inv(pattern2)),
    ):
        start, found = find_bit_pattern_validated(bits, pat, pat2, tol)
        cands.append((start, found))
    found4 = jnp.stack([c[1] for c in cands])
    start4 = jnp.stack([c[0] for c in cands])
    ksel = jnp.argmax(found4)
    s = start4[ksel]
    found = found4[ksel]
    use_im = (ksel == 1) | (ksel == 3)
    invert = (ksel >= 2).astype(jnp.uint8)
    bits = jnp.where(use_im, bits_im, bits_re) ^ invert
    packed, n_valid = pack_bits_from(bits, s)
    return packed, n_valid, found


def bit_sync_and_pack(bits: jnp.ndarray, pattern: str) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Align the bit stream on ``pattern`` and pack to bytes.

    Falls back to offset 0 when the pattern is absent, like the reference
    demodulators (modem.py:130-133). Returns ``(bytes, n_valid, found)``.
    """
    start, found = find_bit_pattern(bits, pattern)
    packed, n_valid = pack_bits_from(bits, start)
    return packed, n_valid, found


# --- spectral front end -------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("low_hz", "high_hz", "sample_rate", "decimate")
)
def analytic_bandpass(
    samples: jnp.ndarray,
    low_hz: float,
    high_hz: float,
    sample_rate: int,
    decimate: int = 1,
) -> jnp.ndarray:
    """Band-limited analytic signal via one FFT round trip.

    Keeps only positive frequencies in ``[low_hz, high_hz]`` (doubled, so the
    magnitude matches the envelope of the real input) and returns the complex
    time-domain signal. ``angle`` / magnitude of this are exactly the
    instantaneous phase/envelope within the band.

    ``decimate=D > 1`` returns ``z[::D]`` EXACTLY (not an approximation): the
    masked spectrum is supported on bins ``[0, n_fft/D)``, so the inverse
    transform of just those bins at 1/D length IS the decimated analytic
    signal. The inverse FFT shrinks by D and the forward transform becomes an
    rfft. Requires ``high_hz < sample_rate/D`` (asserted) and the
    caller to run its downstream at ``sample_rate/D``.
    """
    n = samples.shape[-1]
    # Pad to a power of two: FFT libraries are fastest there, and some
    # backends lower other lengths to a dense DFT matmul.
    n_fft = 1 << (n - 1).bit_length()
    x = samples.astype(jnp.float32)
    if n_fft != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n_fft - n)])
    freqs = np.fft.fftfreq(n_fft, d=1.0 / sample_rate)  # static, host-computed
    band = ((freqs >= max(low_hz, 0.0)) & (freqs <= high_hz)).astype(np.complex64) * 2.0
    # Don't double DC / Nyquist if they fall inside the band.
    if low_hz <= 0.0:
        band[0] = 1.0
    if decimate == 1:
        z = jnp.fft.ifft(jnp.fft.fft(x) * jnp.asarray(band))
        return z[..., :n] if n_fft != n else z
    if high_hz >= sample_rate / decimate:
        raise ValueError(f"band edge {high_hz} aliases at decimation {decimate}")
    if n_fft % decimate:
        raise ValueError("decimate must be a power of two (divides the padded FFT)")
    nd = n_fft // decimate
    # Positive-band-only spectrum: rfft supplies every bin the mask keeps
    # (nd <= n_fft/2 for decimate >= 2). z[m*D] = (1/D) * ifft_{N/D}(Z[:N/D])[m].
    spec = jnp.fft.rfft(x)[..., :nd] * jnp.asarray(band[:nd])
    z = jnp.fft.ifft(spec) / jnp.float32(decimate)
    return z[..., : -(-n // decimate)]


@functools.lru_cache(maxsize=32)
def _analytic_fir_taps(
    low_hz: float, high_hz: float, sample_rate: int, taps: int
) -> np.ndarray:
    """Complex analytic band-pass FIR: windowed-sinc low-pass modulated to the
    band center, linear phase (group delay ``(taps-1)/2``), pass gain 2 (the
    analytic-signal convention: positive frequencies doubled).

    The Blackman window gives ~74 dB stop-band rejection with a transition
    width of ~5.5*fs/taps Hz on each band edge. Unlike the brick-wall FFT
    filter this leaks a sliver of the transition bands, but the discriminator
    equalizer is calibrated against the SAME front end, so the deterministic
    ISI is absorbed; the noise admitted by the slivers is negligible relative
    to the pass band.
    """
    assert taps % 2 == 1, "taps must be odd (integer group delay)"
    c = (taps - 1) // 2
    k = np.arange(taps, dtype=np.float64) - c
    fc = (low_hz + high_hz) / 2.0
    bw = high_hz - low_hz
    lp = (bw / sample_rate) * np.sinc(bw / sample_rate * k) * np.blackman(taps)
    # Normalize the gain AT the band center to exactly 2.
    lp *= 2.0 / lp.sum()
    h = lp * np.exp(2j * np.pi * fc / sample_rate * k)
    return h.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _fir_dec_template(
    low_hz: float, high_hz: float, sample_rate: int, taps: int, dec: int, out_lanes: int
) -> np.ndarray:
    """(L*dec + taps - dec, 2L) matmul template of the decimating analytic
    FIR: column m (< L) holds Re(h) reversed at stride-``dec`` offset m,
    column L+m holds Im(h). One row-block matmul computes L decimated
    analytic samples — see :func:`analytic_bandpass_fir_dec`."""
    h = _analytic_fir_taps(low_hz, high_hz, sample_rate, taps)
    L = out_lanes
    R = L * dec + taps - dec
    W = np.zeros((R, 2 * L), dtype=np.float32)
    rev_re, rev_im = h.real[::-1].astype(np.float32), h.imag[::-1].astype(np.float32)
    for m in range(L):
        W[m * dec : m * dec + taps, m] = rev_re
        W[m * dec : m * dec + taps, L + m] = rev_im
    return W


@functools.partial(
    jax.jit, static_argnames=("low_hz", "high_hz", "sample_rate", "decimate", "taps")
)
def analytic_bandpass_fir_dec(
    samples: jnp.ndarray,
    low_hz: float,
    high_hz: float,
    sample_rate: int,
    decimate: int,
    taps: int = 513,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Decimated band-limited analytic signal as ONE matmul — no FFT.

    Replaces the close-tone FSK front end's whole-capture FFTs. This
    computes the same decimated
    analytic signal by direct decimating convolution with the complex
    band-pass FIR of :func:`_analytic_fir_taps`::

        z[m] = sum_k h[k] * x[m*decimate + (taps-1)//2 - k]

    blocked as overlapped input rows of ``L*dec + taps - dec`` samples times a
    static ``(*, 2L)`` template (L=128 outputs per row: re lanes | im lanes) —
    a dense matmul whose ~2x FLOP overhead over the banded
    structure is far cheaper than the FFT it replaces. Unlike the brick-wall
    FFT mask this has a ~``5.5*sr/taps`` Hz transition at each band edge; the
    discriminator equalizer is calibrated against the SAME front end
    (fir_taps=taps in ``_discriminator_calibration``), so the deterministic
    ISI difference is absorbed. Returns ``(z_re, z_im)`` of length
    ``ceil(n / decimate)``, numerically equal (float tolerance) to
    ``analytic_bandpass_fir(x)[::decimate]``.
    """
    n = samples.shape[-1]
    D, T = decimate, taps
    c = (T - 1) // 2
    L = 128
    if T - D > L * D:
        raise ValueError("taps - decimate must be <= 128*decimate (row overlap)")
    nd_out = -(-n // D)
    r = -(-nd_out // L)
    R = L * D + T - D
    ov = T - D
    x = samples.astype(jnp.float32)
    lead = x.ndim - 1
    pad_cfg = [(0, 0)] * lead + [(c, r * L * D + ov - c - n)]
    xpad = jnp.pad(x, pad_cfg)
    main = xpad[..., : r * L * D].reshape(*x.shape[:-1], r, L * D)
    nxt = jnp.concatenate(
        [
            main[..., 1:, :ov],
            xpad[..., r * L * D : r * L * D + ov][..., None, :],
        ],
        axis=-2,
    )
    rows = jnp.concatenate([main, nxt], axis=-1)  # (..., r, R)
    W = jnp.asarray(
        _fir_dec_template(float(low_hz), float(high_hz), int(sample_rate), T, D, L)
    )
    z2 = jnp.matmul(rows, W, precision=matmul_precision())  # (..., r, 2L)
    zr = z2[..., :L].reshape(*x.shape[:-1], r * L)[..., :nd_out]
    zi = z2[..., L:].reshape(*x.shape[:-1], r * L)[..., :nd_out]
    return zr, zi


@functools.partial(
    jax.jit,
    static_argnames=("low_hz", "high_hz", "sample_rate", "decimate", "taps"),
)
def analytic_fir_dec_rows(
    rows: jnp.ndarray,
    low_hz: float,
    high_hz: float,
    sample_rate: int,
    decimate: int,
    taps: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pre-shaped-rows variant of :func:`analytic_bandpass_fir_dec`.

    ``rows`` are host-built (r, 128*decimate + taps - decimate) overlapped
    windows of ``[zeros((taps-1)//2), x]`` (``ops.fsk.fsk_fir_row_shape`` /
    ``parallel.batch.host_shape_batch``) — identical to the windows the flat
    variant builds on device, so the outputs are bit-equal; the device just
    never pays the pad+reshape+lane-concat relayout. Returns flat
    ``(zr, zi)`` of length ``r*128`` (>= ceil(n/decimate); the tail rows are
    zero-padding's zeros)."""
    D, T, L = decimate, taps, 128
    if rows.shape[-1] != L * D + T - D:
        raise ValueError("rows must be (r, 128*decimate + taps - decimate)")
    W = jnp.asarray(
        _fir_dec_template(float(low_hz), float(high_hz), int(sample_rate), T, D, L)
    )
    z2 = jnp.matmul(rows.astype(jnp.float32), W, precision=matmul_precision())  # (r, 2L)
    r = rows.shape[0]
    return z2[:, :L].reshape(r * L), z2[:, L:].reshape(r * L)


_OLS_BLOCK = 1 << 17  # overlap-save FFT block (power of 2)


@functools.partial(
    jax.jit, static_argnames=("low_hz", "high_hz", "sample_rate", "taps", "block")
)
def analytic_bandpass_fir(
    samples: jnp.ndarray,
    low_hz: float,
    high_hz: float,
    sample_rate: int,
    taps: int = 1025,
    block: int = _OLS_BLOCK,
) -> jnp.ndarray:
    """Band-limited analytic signal via overlap-save FIR convolution.

    Exact linear convolution with :func:`_analytic_fir_taps` (delay-centered,
    so the output is time-aligned with the input like the zero-phase
    brick-wall version), computed as batched power-of-2 FFT blocks instead of
    one whole-capture FFT. On an 8M-sample capture the single padded FFT
    costs ~2x the FLOPs (16M-point round trip) of this batch of short
    FFTs.
    """
    n = samples.shape[-1]
    T = taps
    V = T - 1
    c = V // 2
    if n + V > block:
        blk = block
    else:  # short capture: one block, smallest power of two that fits
        blk = max(256, 1 << int(np.ceil(np.log2(n + V))))
    step = blk - V
    nb = -(-(n + c) // step)
    x = samples.astype(jnp.float32)
    # xp[m] = x[m - V] over [0, (nb+1)*step): left V zeros give each block its
    # overlap context; right zeros square off the reshape.
    pad_cfg = [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, pad_cfg + [(V, (nb + 1) * step - V - n)])
    main = xp[..., : nb * step].reshape(*x.shape[:-1], nb, step)
    tail = xp[..., step : (nb + 1) * step].reshape(*x.shape[:-1], nb, step)[..., :V]
    segs = jnp.concatenate([main, tail], axis=-1)  # (..., nb, blk)

    h = _analytic_fir_taps(float(low_hz), float(high_hz), int(sample_rate), taps)
    H = np.fft.fft(np.pad(h, (0, blk - T))).astype(np.complex64)  # host constant
    y = jnp.fft.ifft(jnp.fft.fft(segs) * jnp.asarray(H))[..., V:]  # (..., nb, step)
    y_full = y.reshape(*x.shape[:-1], nb * step)
    return y_full[..., c : c + n]


def frame_signal(x: jnp.ndarray, frame_len: int, hop: int, n_frames: int) -> jnp.ndarray:
    """Overlapping frames ``x[k*hop : k*hop+frame_len]`` as a (n_frames, frame_len) matrix.

    Implemented as two contiguous reshapes + concat when ``frame_len == 2*hop``
    (the common case here), falling back to a strided gather otherwise.
    """
    n = x.shape[-1]
    if frame_len == 2 * hop:
        need = (n_frames + 1) * hop
        xp = jnp.pad(x, (0, max(0, need - n)))
        a = xp[: n_frames * hop].reshape(n_frames, hop)
        b = xp[hop : hop + n_frames * hop].reshape(n_frames, hop)
        return jnp.concatenate([a, b], axis=1)
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(frame_len)[None, :]
    xp = jnp.pad(x, (0, max(0, int(idx.max()) + 1 - n)))
    return xp[idx]
