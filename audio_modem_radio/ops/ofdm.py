"""Real OFDM: multicarrier DQPSK with per-subcarrier equalization.

The reference's "OFDM4"/"OFDM8" modes are aliases that ignore the subcarrier
count and transmit single-carrier DQPSK (/root/reference/modem.py:371-376).
This module implements genuine OFDM — the BASELINE.json north star explicitly
names "OFDM4/OFDM8 multicarrier encode/decode with per-subcarrier
equalization" as a headline configuration:

* K subcarriers spaced ``sample_rate/S`` apart (orthogonal over one
  S-sample symbol), each carrying Gray-coded DQPSK differentially encoded
  *per subcarrier across time* — robust to unknown channel phase.
* Synthesis is one ``(n_symbols, 2K) @ (2K, S)`` matmul of per-subcarrier
  (cos φ, sin φ) coefficients against the windowed carrier basis — the same
  matmul shape as the PSK modulator, generalized to K carriers.
* The receiver least-squares-projects each symbol window onto the full
  2K-dimensional subcarrier subspace (Gram-inverse dual basis; exact for any
  carrier placement), searches timing offsets in parallel, and applies
  per-subcarrier equalization: each subcarrier's phasor stream is normalized
  by its pilot-estimated channel magnitude so a frequency-selective channel
  can't let one strong subcarrier dominate offset scoring, and per-subcarrier
  gains are exposed to callers.

Bit mapping: the DQPSK preamble bits plus MSB-first data bits are split into
dibits round-robin across subcarriers within each OFDM symbol; byte alignment
on receive is the same magic-pattern search used everywhere else.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .common import bit_sync_and_pack, bytes_to_bits, matmul_precision
from .psk import QPSK_PREAMBLE_BITS

SAMPLE_RATE = 96000


def _symbol_samples(sample_rate: int, symbol_rate: int, n_sub: int) -> int:
    """OFDM symbol length in samples.

    Sized so design throughput tracks the reference efficiency map
    (OFDM4 ~ rate/2 B/s, OFDM8 ~ rate B/s: both give a symbol every
    2/symbol_rate seconds), with a floor of 4 samples per basis dimension so
    the projection stays well-conditioned.
    """
    return max(2 * sample_rate // max(symbol_rate, 1), 8 * n_sub)


@functools.lru_cache(maxsize=64)
def _ofdm_basis(S: int, carrier: float, n_sub: int, sample_rate: int) -> np.ndarray:
    """(2*n_sub, S) basis rows: (sin, cos) per subcarrier, ramp-windowed."""
    t = np.arange(S, dtype=np.float64) / sample_rate
    spacing = sample_rate / S  # orthogonal over one symbol
    env = np.ones(S)
    ramp = max(1, int(S * 0.1))
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    rows = []
    for c in range(n_sub):
        f = carrier + (c - (n_sub - 1) / 2) * spacing
        w = 2 * np.pi * f * t
        rows.append(np.sin(w) * env)
        rows.append(np.cos(w) * env)
    return np.stack(rows).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ofdm_dual_templates(
    S: int, carrier: float, n_sub: int, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(2S, n_offsets*2*n_sub) per-offset Gram-inverse dual bases."""
    B = _ofdm_basis(S, carrier, n_sub, sample_rate).astype(np.float64)  # (2K, S)
    # Shifted windows within a 2-symbol frame, like the PSK templates.
    t2 = np.arange(2 * S, dtype=np.float64) / sample_rate
    spacing = sample_rate / S
    env = np.ones(S)
    ramp = max(1, int(S * 0.1))
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    K2 = 2 * n_sub
    T = np.zeros((2 * S, n_offsets * K2), dtype=np.float64)
    for i in range(n_offsets):
        o = i * S // n_offsets
        Bo = np.zeros((K2, S))
        for c in range(n_sub):
            f = carrier + (c - (n_sub - 1) / 2) * spacing
            w = 2 * np.pi * f * t2[o : o + S]
            Bo[2 * c] = np.sin(w) * env
            Bo[2 * c + 1] = np.cos(w) * env
        G = Bo @ Bo.T + 1e-9 * np.eye(K2)
        D = np.linalg.solve(G, Bo)  # (K2, S)
        T[o : o + S, i * K2 : (i + 1) * K2] = D.T
    return T.astype(np.float32)


def ofdm_modulate(
    data_bytes: bytes,
    baud: float = 9600,
    carrier: float = 12000.0,
    num_subcarriers: int = 4,
    samp_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Multicarrier DQPSK synthesis."""
    K = num_subcarriers
    S = _symbol_samples(samp_rate, int(baud), K)
    bits = np.concatenate(
        [np.asarray(QPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    )
    if len(bits) % 2:
        bits = np.concatenate([bits, np.zeros(1, np.uint8)])
    hi, lo = bits[0::2].astype(np.int64), bits[1::2].astype(np.int64)
    deltas = hi * 3 + lo * (1 - 2 * hi)  # Gray dibit -> quarter turns
    n_dibits = len(deltas)
    n_sym = -(-n_dibits // K)
    deltas = np.pad(deltas, (0, n_sym * K - n_dibits))  # (n_sym*K,)
    # Differential accumulation per subcarrier across time.
    grid = deltas.reshape(n_sym, K)
    phase_qt = np.cumsum(grid, axis=0) % 4  # (n_sym, K)
    cos_t = np.array([1.0, 0.0, -1.0, 0.0])[phase_qt]
    sin_t = np.array([0.0, 1.0, 0.0, -1.0])[phase_qt]
    coeff = np.empty((n_sym, 2 * K), np.float32)
    coeff[:, 0::2] = cos_t
    coeff[:, 1::2] = sin_t
    B = _ofdm_basis(S, float(carrier), K, samp_rate)
    out = jnp.matmul(jnp.asarray(coeff), jnp.asarray(B), precision=matmul_precision())  # (n_sym, S)
    wave = np.asarray(out).reshape(-1)
    peak = np.max(np.abs(wave))
    return (wave / peak * 0.9).astype(np.float32) if peak > 0 else wave.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ofdm_blocked_dual(
    S: int, carrier: float, n_sub: int, sample_rate: int, L: int
) -> np.ndarray:
    """(L*S, 2*L*K) block-diagonal offset-0 dual template, lanes-major.

    Row-block l (samples ``[l*S, (l+1)*S)``) projects symbol l onto the K
    subcarriers: column ``l*K + k`` holds the sin-coefficient dual of
    subcarrier k, column ``L*K + l*K + k`` the cos-coefficient dual — so one
    ``(r, L*S) @ (L*S, 2*L*K)`` matmul projects L symbols per row and the
    output halves are contiguous [re lanes | im lanes], symbol-major /
    subcarrier-minor (the round-robin wire order).
    """
    B = _ofdm_basis(S, carrier, n_sub, sample_rate).astype(np.float64)  # (2K, S)
    G = B @ B.T + 1e-9 * np.eye(2 * n_sub)
    D = np.linalg.solve(G, B)  # (2K, S)
    K = n_sub
    W = np.zeros((L * S, 2 * L * K), dtype=np.float32)
    for l in range(L):
        for k in range(K):
            W[l * S : (l + 1) * S, l * K + k] = D[2 * k]
            W[l * S : (l + 1) * S, L * K + l * K + k] = D[2 * k + 1]
    return W


def _ofdm_rows_per_block(S: int) -> int:
    """Symbols per row-block: keep the matmul ~(1024, 256)-shaped (the
    measured sweet spot of the PSK blocked path) for any symbol length."""
    return max(1, 1024 // S)


def ofdm_blocked_row_shape(
    n_samples: int, baud: float, n_sub: int, sample_rate: int
) -> Optional[Tuple[int, int, int]]:
    """(r, row=L*S, overlap=S) geometry for host-side overlapped-row shaping.

    ``parallel.batch.host_shape_batch`` uses this to pre-build the
    (r, L*S+S) rows :func:`_ofdm_decision_streams` consumes directly — the
    rows are offset-independent (the timing offset selects a row-shifted
    weight table), so the build is two numpy strided views on the host
    instead of a pad+reshape+lane-concat relayout on the device. Returns
    None when the capture is too short to demodulate (< 3 symbols)."""
    S = _symbol_samples(sample_rate, int(baud), int(n_sub))
    L = _ofdm_rows_per_block(S)
    n_sym = int(n_samples) // S
    if n_sym < 3:
        return None
    r = -(-n_sym // L)
    return r, L * S, S


def _ofdm_shift_tables(
    S: int, carrier: float, n_sub: int, sample_rate: int, L: int, guard: jnp.ndarray
) -> jnp.ndarray:
    """(S, L*S+S, 2*L*K) row-shifted blocked duals, one per timing offset.

    Row i of the off-shifted stream lives in the OVERLAPPED row
    ``flat[i*L*S : (i+1)*L*S + S]``, so its projection is one matmul
    ``rows_ov @ T[off]`` where ``T[o][j] = W[j-o]`` for ``o <= j < o+L*S``
    and zero elsewhere. Selecting ``T[off]`` by a traced offset is ONE
    aligned leading-dim index — replacing a traced, misaligned
    ``dynamic_slice`` of the whole sample stream per capture.

    Built IN-GRAPH from the 1 MB blocked dual so the ~33 MB table is
    materialized on device per dispatch (cheap HBM writes) instead of being
    constant-folded into the executable (which would bloat every compile).
    ``guard`` must be a traced scalar
    equal to 1 (e.g. ``1 + 0*samples[0]``) to force runtime dependence; pass
    it from OUTSIDE any vmap or the table batches per capture."""
    W = jnp.asarray(_ofdm_blocked_dual(S, carrier, n_sub, sample_rate, L))
    LS, C = W.shape
    z = jnp.concatenate(
        [jnp.zeros((S, C), jnp.float32), W * guard, jnp.zeros((S, C), jnp.float32)]
    )
    return jnp.stack(
        [jax.lax.slice(z, (S - o, 0), (S - o + LS + S, C)) for o in range(S)]
    )


def _ofdm_decision_streams(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    sample_rate: int,
    n_offsets: int = 0,
    cfo: bool = True,
    tables: Optional[jnp.ndarray] = None,
    tracked: bool = False,
    window: int = 64,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Demodulate OFDM to dual dibit streams (hi, lo, best_score, gains).

    ``tables`` (optional) is the prebuilt :func:`_ofdm_shift_tables` array;
    batch callers MUST build it once outside their vmap — a vmapped build
    would batch the ~33 MB table per capture.

    ``n_offsets=0`` (default) searches every sample offset within a symbol:
    multicarrier projection suffers inter-carrier interference at even
    fractional-symbol timing error, so unlike the PSK path a coarse offset
    grid is not enough.

    Blocked layout: pass 2 never materializes ``(n_sym, S)`` /
    ``(n_sym, K, 2)`` tensors with small minor dims. Instead the flat sample stream is shifted by the
    winning offset with one dynamic slice and projected by a single blocked
    ``(r, L*S) @ (L*S, 2*L*K)`` matmul against the offset-0 dual template
    (:func:`_ofdm_blocked_dual`) — valid because shifting the stream turns
    the per-offset dual into a constant per-subcarrier rotation, which
    cancels in the per-subcarrier differential. All downstream math
    (differentials, equalization, Gray decisions) runs on flat lanes-major
    streams with static K-lane shifts, and the (hi, lo) decision bits stay
    DUAL streams — interleaving them would materialize an ``(n, 2)`` layout
    (the batched sync tails consume dual streams directly, like the PSK
    path).
    """
    K = n_sub
    K2 = 2 * K
    S = _symbol_samples(sample_rate, int(baud), K)
    L = _ofdm_rows_per_block(S)
    LS = L * S
    if n_offsets <= 0:
        n_offsets = S

    # Pre-shaped input (round 3): a (r, L*S+S) overlapped-row layout built on
    # the HOST with cheap strided views (``ofdm_blocked_row_shape`` /
    # ``parallel.batch.host_shape_batch``) — the overlapped rows do not
    # depend on the timing offset (the offset selects a row-shifted weight
    # table, see pass 2), so the device never pays the pad+reshape+lane-
    # concat row build (as host shaping does for the PSK and dual-tone FSK
    # paths). Trailing zero symbols
    # beyond the true capture only add zero projections: they scale every
    # subcarrier gain by the same factor (decisions are signs — unaffected)
    # and contribute nothing to the rotation estimate or the magic scan.
    pre_shaped = samples.ndim == 2
    if pre_shaped:
        rows_ov = samples.astype(jnp.float32)
        r = rows_ov.shape[0]
        if rows_ov.shape[1] != LS + S:
            raise ValueError("pre-shaped OFDM rows must be (r, L*S+S)")
        n_sym = r * L
    else:
        n = samples.shape[-1]
        # CEIL, not floor: at a timing offset o > 0 the final symbol's last o
        # samples fall in the trailing partial block — flooring truncated
        # them, corrupting the frame's LAST dibits (the tail of the part CRC)
        # whenever a capture's leading-silence length was ≢ 0 mod S (the same
        # defect the round-3 chaos sweep exposed in psk_demod_streams; the
        # zero-pad keeps every real sample and the all-zero tail adds only
        # garbage trailing dibits, which the parser ignores).
        n_sym = -(-n // S)
    if n_sym < 3:
        raise ValueError("signal shorter than three OFDM symbols")
    if not pre_shaped:
        xf = samples.astype(jnp.float32)
        if n_sym * S > n:
            xf = jnp.pad(xf, (0, n_sym * S - n))
    T = jnp.asarray(_ofdm_dual_templates(S, float(carrier), K, sample_rate, n_offsets))

    # --- pass 1: all-offset timing search on up to 3 SMALL symbol windows ---
    # The old all-offsets projection over the full capture materialized a
    # (n_sym, S, 2K) tensor — ~1 GB for a 5-minute capture at 160-sample
    # symbols. Timing needs only a few hundred symbols of evidence; the full
    # capture is then projected once at the winning offset (pass 2).
    wsyms = min(n_sym - 1, 256)
    starts = sorted({0, max(0, n_sym // 2 - wsyms // 2), max(0, n_sym - 1 - wsyms)})
    if pre_shaped:
        # Slice evidence windows from the overlapped rows: round each start
        # down to a row boundary; ``wrows`` rows plus the last row's overlap
        # tail contain the window's (wsyms+1)*S contiguous samples.
        wrows = -(-(wsyms + 1) // L)
        wins = []
        for s in starts:
            r0 = min(s // L, r - wrows)
            w = rows_ov[r0 : r0 + wrows]
            flat_w = jnp.concatenate([w[:, :LS].reshape(-1), w[-1, LS:]])
            wins.append(flat_w[: (wsyms + 1) * S])
    else:
        wins = [
            jax.lax.dynamic_slice(xf, (s * S,), ((wsyms + 1) * S,)) for s in starts
        ]
    xw = jnp.concatenate([w[: wsyms * S].reshape(wsyms, S) for w in wins], axis=0)
    xw_next = jnp.concatenate([w[S:].reshape(wsyms, S) for w in wins], axis=0)
    projw = (
        jnp.matmul(xw, T[:S], precision=matmul_precision())
        + jnp.matmul(xw_next, T[S:], precision=matmul_precision())
    ).reshape(-1, n_offsets, K, 2)
    rew, imw = projw[..., 0], projw[..., 1]  # (nw, n_off, K)

    # Per-subcarrier channel-magnitude equalization per offset hypothesis,
    # so frequency-selective channels can't let one strong subcarrier
    # dominate offset scoring (the "per-subcarrier equalization"). Estimated
    # over the windows, not preamble slots: real captures can lead with
    # silence, which would zero a preamble-indexed pilot estimate.
    gains_w = jnp.sqrt(jnp.mean(rew**2 + imw**2, axis=0)) + 1e-9
    rew = rew / gains_w[None]
    imw = imw / gains_w[None]

    d_re = rew[1:] * rew[:-1] + imw[1:] * imw[:-1]
    d_im = imw[1:] * rew[:-1] - rew[1:] * imw[:-1]
    # 4-fold phase-coherence offset score (see psk.py for why not energy).
    a, b = d_re * d_re, d_im * d_im
    score = jnp.sum(((a - b) ** 2 - 4 * a * b) / (a + b + 1e-20), axis=(0, 2))
    best = jnp.argmax(score)

    # --- pass 2: one overlapped matmul via row-shifted weight tables --------
    # The off-shifted stream never materializes: row i of it lives in the
    # S-overlapped row ``flat[i*L*S : (i+1)*L*S + S]``, projected in ONE
    # matmul against the offset-selected table (_ofdm_shift_tables) instead
    # of a misaligned traced ``dynamic_slice`` of the stream.
    LK = L * K
    if not pre_shaped:
        r = -(-n_sym // L)
    if tables is None:
        tables = _ofdm_shift_tables(
            S, float(carrier), K, sample_rate, L,
            1.0 + 0.0 * (rows_ov[0, 0] if pre_shaped else xf[0]),
        )
    off = best * S // n_offsets  # offset index -> sample offset (< S)
    if not pre_shaped:
        xpad = jnp.concatenate([xf, jnp.zeros(((r + 1) * LS - n_sym * S,), jnp.float32)])
        main = xpad[: r * LS].reshape(r, LS)
        nxt = xpad[LS:].reshape(r, LS)[:, :S]  # first S samples of each next row
        rows_ov = jnp.concatenate([main, nxt], axis=1)  # (r, LS+S)
    proj = jnp.matmul(rows_ov, tables[off], precision=matmul_precision())  # (r, 2*L*K): [re | im]
    re = proj[:, :LK].reshape(-1)  # (r*L*K,) symbol-major, k-minor
    im = proj[:, LK:].reshape(-1)

    # Lanes-major gains: (r, L*K) tile column-sums folded to (K,) — never an
    # (n, K) minor-dim layout. Padded tail symbols are zero rows, so they add
    # nothing to the sums.
    p2 = (re * re + im * im).reshape(r, LK)
    gains = jnp.sqrt(jnp.sum(p2, axis=0).reshape(L, K).sum(0) / n_sym) + 1e-9

    # Per-subcarrier differentials: the next symbol's phasor for subcarrier
    # k is K lanes ahead in the flat stream — a static shift, no transpose.
    # Computed full-length (zero tail) so the equalization weight applies as
    # a 128-lane broadcast pattern instead of an (n, K) reshape.
    re_n = jnp.concatenate([re[K:], jnp.zeros((K,), jnp.float32)])
    im_n = jnp.concatenate([im[K:], jnp.zeros((K,), jnp.float32)])
    dr = re_n * re + im_n * im
    di = im_n * re - re_n * im
    # Equalize the differentials (scales by 1/g_k^2 — sign-preserving, so
    # decisions are unaffected; it weights the blind rotation estimate so a
    # strong subcarrier can't dominate it). Lane j of an LK-wide row is
    # subcarrier j % K, so the weight is a tiled (LK,) pattern.
    inv2 = 1.0 / (gains * gains)
    pattern = jnp.tile(inv2, L)[None, :]
    dr = (dr.reshape(r, LK) * pattern).reshape(-1)
    di = (di.reshape(r, LK) * pattern).reshape(-1)
    n_d = (n_sym - 1) * K
    dr, di = dr[:n_d], di[:n_d]

    # CFO handling: a carrier offset advances EVERY subcarrier's symbol phase
    # by the same 2πδ·S/fs per symbol, i.e. a constant rotation of all
    # differential phasors — estimated blind (4th power, mod π/2) and
    # derotated here; the residual k·π/2 sector relabeling is resolved by the
    # caller's quarter-turn sync retry, exactly like the PSK path. ``cfo=False``
    # (the carrier-exact knob) skips the blind estimate entirely.
    if cfo:
        from .psk import derotate, estimate_common_rotation

        theta = estimate_common_rotation(dr, di)
        dr, di = derotate(dr, di, theta)

    if tracked:
        # The tracked decisions read only the raw phasors (re, im); the
        # differential/equalization/derotation chain above feeds only the
        # (dr, di) ride-along outputs, which the sole tracked caller
        # (_ofdm_bytes_tracked, jitted) discards — XLA dead-code-eliminates
        # the whole chain from the compiled escalation program, so sharing
        # one front end costs trace time only, not runtime.
        hi, lo = _ofdm_tracked_dibits(re, im, r * L, K, n_sym, window)
    else:
        swap = jnp.abs(di) > jnp.abs(dr)
        neg = jnp.where(swap, di < 0, dr < 0)
        hi = neg.astype(jnp.uint8)
        lo = jnp.where(swap, ~neg, neg).astype(jnp.uint8)
    # Round-robin subcarrier order: symbol-major, subcarrier-minor — dibit i
    # is (hi[i], lo[i]); already the flat wire order. (dr, di) ride along for
    # the soft-decision escalations (ofdm_soft_bits).
    return hi, lo, score[best], gains, dr, di


def _ofdm_tracked_dibits(
    re: jnp.ndarray, im: jnp.ndarray, n_tot: int, K: int, n_sym, window: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-subcarrier Viterbi&Viterbi-tracked Gray dibit streams (wire order).

    OFDM is per-subcarrier differential DQPSK across TIME, so each
    subcarrier pays the same ~2.3 dB noisy-reference penalty the
    single-carrier PSK family stopped paying in round 4
    (ops/psk._tracked_phase; PERF.md "Coherent-tracked PSK escalation").
    This applies the z⁴ tracker independently per subcarrier — the channel
    phase differs per subcarrier, the residual-CFO rate is common but each
    track re-estimates it from its own stream (K ≤ 8 streams, so the
    redundant estimate is noise-averaging, not a cost) — then makes
    ABSOLUTE quarter-turn decisions against each track and differentially
    decodes in sector space across time. The per-subcarrier constant k·π/2
    track ambiguity cancels in the delta, exactly like the PSK family.

    Layout note: this reshapes the flat symbol-major/K-minor streams to
    (K, n_sym) — an (n, K) small-minor-dim layout the fast path avoids.
    The tracked pass is escalation-only (runs when the differential pass
    found no complete capture), so its cost is failure-proportional, not a
    hot-path cost.

    Trailing padded symbols are zero phasors: they contribute zero to the
    energy-weighted window average and the ramp estimate, and their sector
    deltas land beyond ``n_sym - 1`` where the caller truncates.
    """
    from .psk import _tracked_phase

    reK = re.reshape(n_tot, K).T  # (K, n_tot) per-subcarrier streams
    imK = im.reshape(n_tot, K).T
    th = jax.vmap(lambda a, b: _tracked_phase(a, b, 4, window))(reK, imK)
    c, s = jnp.cos(th), jnp.sin(th)
    wr = reK * c + imK * s
    wi = imK * c - reK * s
    horiz = jnp.abs(wr) >= jnp.abs(wi)
    k_abs = jnp.where(
        horiz, jnp.where(wr >= 0, 0, 2), jnp.where(wi >= 0, 1, 3)
    ).astype(jnp.int32)
    d = (k_abs[:, 1:] - k_abs[:, :-1]) % 4  # (K, n_tot-1) deltas across time
    g = d ^ (d >> 1)  # sector delta -> Gray dibit (same wire map as DQPSK)
    hi = ((g >> 1) & 1).astype(jnp.uint8).T.reshape(-1)  # symbol-major, k-minor
    lo = (g & 1).astype(jnp.uint8).T.reshape(-1)
    n_d = (n_sym - 1) * K
    return hi[:n_d], lo[:n_d]


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "n_sub", "sample_rate", "pattern", "pattern2", "window"),
)
def _ofdm_bytes_tracked(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    sample_rate: int,
    pattern: str,
    pattern2: str = "",
    window: int = 64,
):
    """Tracked-OFDM demod to bytes: shared projection front end, per-
    subcarrier V&V tracked dibits, 4-hypothesis rotation sync + pack (the
    tracker's k·π/2 ambiguities cancel in the deltas, so hypothesis k=0
    matches — the shared sync costs nothing extra)."""
    from .common import dibit_sync_and_pack_rotations

    hi, lo, _s, _g, _dr, _di = _ofdm_decision_streams(
        samples, baud, carrier, n_sub, sample_rate, tracked=True, window=window
    )
    return dibit_sync_and_pack_rotations(hi, lo, pattern, pattern2)


def ofdm_tracked_demodulate(
    samples: np.ndarray,
    baud: float = 9600,
    carrier: float = 12000.0,
    num_subcarriers: int = 4,
    samp_rate: int = SAMPLE_RATE,
    window: int = 64,
) -> bytes:
    """Coherent-tracked OFDM receive — recovers the per-subcarrier
    differential-detection penalty (~2 dB at the OFDM4/OFDM8 waterfalls,
    benchmarks/ofdm_bound.py) at ~1× extra decision cost over the shared
    projection front end. The mode ladder escalates here when the
    differential pass yields no complete capture
    (modem._ofdm_mode_demodulate); the default 64-symbol window (vs PSK's
    128) reflects OFDM's shorter per-subcarrier streams — an OFDM symbol
    carries K dibits, so streams are K× shorter than the single-carrier
    equivalent."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    packed, n_valid, _found = _ofdm_bytes_tracked(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(num_subcarriers), int(samp_rate),
        MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "n_sub", "sample_rate", "n_offsets", "n_pilot"),
)
def ofdm_demod_bits(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    sample_rate: int,
    n_offsets: int = 0,
    n_pilot: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Single-capture API: interleaved (bits, best_score, subcarrier_gains).

    Thin wrapper over :func:`_ofdm_decision_streams`; the interleave is fine
    at single-capture scale (the batched path consumes the dual streams
    directly via :func:`ofdm_decision_streams_batch`).
    """
    del n_pilot
    hi, lo, best_score, gains, _dr, _di = _ofdm_decision_streams(
        samples, baud, carrier, n_sub, sample_rate, n_offsets
    )
    bits = jnp.stack([hi, lo], axis=1).reshape(-1)
    return bits, best_score, gains


@functools.partial(
    jax.jit,
    static_argnames=("baud", "carrier", "n_sub", "sample_rate", "cfo"),
)
def ofdm_decision_streams_batch(
    samples: jnp.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    sample_rate: int,
    cfo: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched captures -> dual (hi, lo) dibit streams, each (B, n_dibits).

    The batched receive entry: vmapped core demod with NO bit interleave —
    the dual streams feed the same rotation-sync/pack tails as the DQPSK
    path (OFDM dibits are Gray pairs with the identical k*pi/2 relabeling
    algebra). Accepts (B, N) flat captures or the
    host pre-shaped (B, r, L*S+S) overlapped rows (``ofdm_blocked_row_shape``
    + ``host_shape_batch``), which skip the device-side row build.
    """
    S = _symbol_samples(sample_rate, int(baud), n_sub)
    L = _ofdm_rows_per_block(S)
    tables = _ofdm_shift_tables(
        S, float(carrier), n_sub, sample_rate, L, 1.0 + 0.0 * samples.reshape(-1)[0]
    )
    hi, lo, _score, _gains, _dr, _di = jax.vmap(
        lambda x: _ofdm_decision_streams(
            x, baud, carrier, n_sub, sample_rate, cfo=cfo, tables=tables
        )
    )(samples)
    return hi, lo


@functools.partial(
    jax.jit, static_argnames=("baud", "carrier", "n_sub", "sample_rate")
)
def _ofdm_soft_streams(samples, baud, carrier, n_sub, sample_rate):
    _hi, _lo, _s, _g, dr, di = _ofdm_decision_streams(
        samples, baud, carrier, n_sub, sample_rate
    )
    return dr, di


def ofdm_soft_bits(
    samples: np.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    sample_rate: int,
) -> np.ndarray:
    """Soft dibit stream in [0, 1] for the soft-decision FEC escalations.

    The OFDM Gray decision regions are the SAME diagonal mapping as DQPSK
    (hi = 1 iff dr+di < 0, lo = 1 iff di-dr > 0 — verify against the
    sector table in ``_ofdm_decision_streams``), so each bit's soft value
    is a linear scaling of its own rotated component, exactly like
    ops.psk.psk_soft_bits. Consumed by decoder._stream_fec_soft and
    decoder.recover_payload_fec_soft for the OFDM mode family.
    """
    dr, di = _ofdm_soft_streams(
        jnp.asarray(samples, jnp.float32), float(baud), float(carrier),
        int(n_sub), int(sample_rate),
    )
    dr, di = np.asarray(dr), np.asarray(di)
    scale = np.mean(np.abs(dr) + np.abs(di)) + 1e-9
    a = dr + di  # hi = 1 when a < 0
    b = di - dr  # lo = 1 when b > 0
    soft = np.empty(2 * len(a), np.float32)
    soft[0::2] = np.clip(0.5 - a / scale, 0.0, 1.0)
    soft[1::2] = np.clip(0.5 + b / scale, 0.0, 1.0)
    return soft


def ofdm_demodulate(
    samples: np.ndarray,
    baud: float = 9600,
    carrier: float = 12000.0,
    num_subcarriers: int = 4,
    samp_rate: int = SAMPLE_RATE,
) -> bytes:
    """OFDM receive chain: bits -> magic-aligned bytes."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    bits, _score, _gains = ofdm_demod_bits(
        jnp.asarray(samples, jnp.float32),
        float(baud),
        float(carrier),
        int(num_subcarriers),
        int(samp_rate),
    )
    # Quarter-turn rotation retry (the k·π/2 residual of the blind CFO
    # derotation inside ofdm_demod_bits): the interleaved bit stream's dibits
    # ARE the Gray pairs, so the PSK rotation sync applies unchanged.
    from .common import dibit_sync_and_pack_rotations

    packed, n_valid, _found = dibit_sync_and_pack_rotations(
        bits[0::2], bits[1::2], MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    )
    return bytes(np.asarray(packed)[: int(n_valid)])


def estimate_subcarrier_gains(
    samples: np.ndarray,
    baud: float = 9600,
    carrier: float = 12000.0,
    num_subcarriers: int = 4,
    samp_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Pilot-estimated per-subcarrier channel magnitudes (diagnostics API)."""
    _bits, _score, gains = ofdm_demod_bits(
        jnp.asarray(samples, jnp.float32),
        float(baud),
        float(carrier),
        int(num_subcarriers),
        int(samp_rate),
    )
    return np.asarray(gains)
