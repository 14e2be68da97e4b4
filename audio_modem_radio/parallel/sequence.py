"""Sequence parallelism: one long capture sharded across the device mesh.

Batch (data) parallelism covers the many-captures case; this module covers
the other axis — a single capture too long (or too latency-sensitive) for one
chip. The sample axis is sharded contiguously across the mesh and each device
demodulates its shard, with the two cross-shard couplings handled explicitly
(SURVEY.md §5 maps the reference's "long audio stream" handling onto exactly
this):

* **Halo exchange** — the last symbol of shard d needs the head of shard d+1
  (the 2-symbol projection window and the differential product both cross the
  boundary). A single ``ppermute`` moves each shard's head to its left
  neighbor.
* **Global timing consensus** — every shard scores the timing offsets
  locally, then a ``psum`` over the mesh combines the scores so all shards
  project at the same winning offset (a shard of leading silence must not
  pick its own garbage offset).

Output bits come back sharded on the same axis; magic sync and byte packing
then run on the logically-global bit array (GSPMD inserts the boundary
communication for the shifted slices).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.fsk import (
    _fsk_blocked_templates,
    _fsk_geometry,
    _samples_per_bit,
    _separation_cycles,
)
from ..ops.psk import (
    _BLOCK_SYM,
    _blocked_templates,
    _coherence_parts_pow,
    _gram_scale,
    _offset_grams,
    _samples_per_symbol,
    qpsk_gray_streams,
)
from ..ops.common import matmul_precision
from .mesh import DATA_AXIS

SAMPLE_RATE = 96000


def demod_capture_sharded(
    samples: np.ndarray,
    baud: float,
    carrier: float,
    mesh: Mesh,
    n_psk: int = 4,
    sample_rate: int = SAMPLE_RATE,
    n_offsets: int = 8,
    raw: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate ONE capture with its sample axis sharded over ``mesh``.

    Returns ``(d_re, d_im)`` differential streams (still sharded on the
    mesh's data axis). The capture is padded so each shard holds a whole
    number of 128-symbol rows. Timing consensus scores at the
    data-cancelling power for ``n_psk`` (8th power for D8PSK, else 4th).
    ``raw=True`` skips the differential and returns the RAW per-symbol
    projection phasors instead — the DSSS despreader's front end, where
    chips must sum coherently per data bit BEFORE any differential
    (ops/dsss.py; mirrors ``psk_raw_streams_batch``).
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    n_dev = int(np.prod(list(mesh.shape.values())))
    row = _BLOCK_SYM * spsym
    W8 = _blocked_templates(spsym, float(carrier), sample_rate, n_offsets)
    c = W8.shape[1]
    ov = c - row

    # Pad so each shard gets a whole number of rows — at least 2, so the
    # (row+ov)-sample halo head always fits within one shard.
    n = len(samples)
    r_total = max(2 * n_dev, -(-(-(-n // row)) // n_dev) * n_dev)
    x = np.zeros(r_total * row, dtype=np.float32)
    x[:n] = samples[: r_total * row]
    r_local = r_total // n_dev

    W8j = jnp.asarray(W8)
    grams_j = jnp.asarray(_offset_grams(spsym, float(carrier), sample_rate, n_offsets))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
    )
    def _shard_demod(x_local: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        # x_local: (r_local*row,) contiguous samples of this shard.
        xr = x_local.reshape(r_local, row)

        # Halo: this shard's head row -> left neighbor (so each shard can
        # extend its last row's windows and final differential).
        head = x_local[: row + ov]
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(head[None], DATA_AXIS, perm)[0]

        ext = jnp.concatenate([x_local, halo])
        nxt = jnp.concatenate(
            [xr[1:, :ov], jax.lax.dynamic_slice(ext, (r_local * row,), (ov,))[None]],
            axis=0,
        )
        xov = jnp.concatenate([xr, nxt], axis=1)  # (r_local, row+ov)

        # Local offset scores -> global consensus via psum.
        proj_all = jnp.matmul(
            xov, W8j.transpose(1, 0, 2).reshape(c, -1), precision=matmul_precision()
        )
        pa = proj_all.reshape(r_local, n_offsets, 2, _BLOCK_SYM)
        re_a, im_a = pa[:, :, 0], pa[:, :, 1]
        re_a, im_a = _gram_scale(re_a, im_a, grams_j, offset_axis=1)
        dr_a = re_a[..., 1:] * re_a[..., :-1] + im_a[..., 1:] * im_a[..., :-1]
        di_a = im_a[..., 1:] * re_a[..., :-1] - re_a[..., 1:] * im_a[..., :-1]
        # Coherence combine: psum the complex-sum components, THEN take the
        # magnitude (summing local magnitudes would over-count shards whose
        # phasors are incoherent with the rest).
        nr, ni = _coherence_parts_pow(dr_a, di_a, (0, 2), n_psk)  # (K,) each
        nr = jax.lax.psum(nr, DATA_AXIS)
        ni = jax.lax.psum(ni, DATA_AXIS)
        score = jnp.hypot(nr, ni)
        best = jnp.argmax(score)

        out = jnp.matmul(xov, W8j[best], precision=matmul_precision())  # (r_local, 256)
        re = out[:, :_BLOCK_SYM].reshape(-1)
        im = out[:, _BLOCK_SYM:].reshape(-1)

        if raw:
            return re, im

        # Differential: the final element needs the first symbol of the next
        # shard — project the halo window (only its symbol 0 is used, so the
        # halo's own missing overlap tail doesn't matter).
        # (1, 256): neighbor's first symbols
        nb = jnp.matmul(halo[None, :], W8j[best], precision=matmul_precision())
        re_ext = jnp.concatenate([re, nb[0, :1]])
        im_ext = jnp.concatenate([im, nb[0, _BLOCK_SYM : _BLOCK_SYM + 1]])
        d_re = re_ext[1:] * re_ext[:-1] + im_ext[1:] * im_ext[:-1]
        d_im = im_ext[1:] * re_ext[:-1] - re_ext[1:] * im_ext[:-1]
        return d_re, d_im

    x_dev = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))  # host -> shards
    return _shard_demod(x_dev)


def demod_fsk_capture_sharded(
    samples: np.ndarray,
    baud: float,
    mark: float,
    space: float,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
    n_offsets: int = 8,
) -> jnp.ndarray:
    """Dual-tone FSK demod of ONE capture, sample axis sharded over ``mesh``.

    Simpler couplings than the PSK case: the detector is per-bit noncoherent
    energy (no differential), so the only cross-shard data is the row
    overlap — each shard receives its right neighbor's first ``ov`` samples
    via one ``ppermute``. Bit-offset scoring still needs the global ``psum``
    consensus (a shard of leading silence must not pick its own offset).
    Returns the bit array, still sharded on the mesh's data axis.
    """
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        raise ValueError(
            "sequence-parallel FSK covers dual-tone configs; close-tone "
            "discriminator configs decode via the batched or single paths"
        )
    spr, row, ov = _fsk_geometry(spb)
    n_dev = int(np.prod(list(mesh.shape.values())))
    W = jnp.asarray(
        _fsk_blocked_templates(spb, float(mark), float(space), sample_rate, n_offsets)
    )
    c = row + ov

    n = len(samples)
    r_total = max(2 * n_dev, -(-(-(-n // row)) // n_dev) * n_dev)
    x = np.zeros(r_total * row, dtype=np.float32)
    x[:n] = samples[: r_total * row]
    r_local = r_total // n_dev

    @functools.partial(
        shard_map, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS)
    )
    def _shard_demod(x_local: jnp.ndarray) -> jnp.ndarray:
        xr = x_local.reshape(r_local, row)
        head = x_local[:ov]  # right neighbor's head completes the last row
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(head[None], DATA_AXIS, perm)[0]
        nxt = jnp.concatenate([xr[1:, :ov], halo[None]], axis=0)
        xov = jnp.concatenate([xr, nxt], axis=1)  # (r_local, row+ov)

        # Local offset margins -> global consensus.
        pj = jnp.matmul(
            xov, W.transpose(1, 0, 2).reshape(c, -1), precision=matmul_precision()
        ).reshape(r_local, n_offsets, 4, spr)
        em = pj[:, :, 0] ** 2 + pj[:, :, 1] ** 2
        es = pj[:, :, 2] ** 2 + pj[:, :, 3] ** 2
        local_score = jnp.sum(jnp.abs(em - es), axis=(0, 2))  # (n_offsets,)
        score = jax.lax.psum(local_score, DATA_AXIS)
        best = jnp.argmax(score)

        pj2 = jnp.matmul(xov, W[best], precision=matmul_precision()).reshape(r_local, 4, spr)
        margin = (pj2[:, 0] ** 2 + pj2[:, 1] ** 2) - (pj2[:, 2] ** 2 + pj2[:, 3] ** 2)
        return (margin > 0).astype(jnp.uint8).reshape(-1)

    x_dev = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))  # host -> shards
    return _shard_demod(x_dev)


def demod_ofdm_capture_sharded(
    samples: np.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """OFDM demod of ONE capture, sample axis sharded over ``mesh``.

    Cross-shard couplings: the S-sample row overlap (one ``ppermute`` of the
    right neighbor's head), the timing-offset consensus (each shard scores a
    window of its OWN symbols — 8 shards give better evidence coverage than
    the single-device core's 3 windows — and a ``psum`` combines them), and
    the per-subcarrier differential at the shard boundary (one ``ppermute``
    of the neighbor's first symbol's projections). Subcarrier-gain
    equalization is skipped: it scales each subcarrier's differential by a
    positive constant, and the Gray decisions are signs. Like the PSK
    sequence path this assumes a carrier-exact capture (no blind CFO
    derotation); CFO-robust decode is the batched path's job. Returns the
    dual (hi, lo) dibit streams, still sharded on the mesh's data axis.
    """
    from ..ops.ofdm import (
        _ofdm_dual_templates,
        _ofdm_rows_per_block,
        _ofdm_shift_tables,
        _symbol_samples,
    )

    K = int(n_sub)
    S = _symbol_samples(sample_rate, int(baud), K)
    L = _ofdm_rows_per_block(S)
    LS, LK = L * S, L * K
    n_offsets = S
    n_dev = int(np.prod(list(mesh.shape.values())))

    n = len(samples)
    r_total = max(n_dev, -(-(-(-n // LS)) // n_dev) * n_dev)
    x = np.zeros(r_total * LS, dtype=np.float32)
    x[:n] = samples[: r_total * LS]
    r_local = r_total // n_dev
    if r_local * L < 3:
        raise ValueError("capture too short per shard for OFDM timing search")

    T = jnp.asarray(_ofdm_dual_templates(S, float(carrier), K, sample_rate, n_offsets))
    tables = _ofdm_shift_tables(
        S, float(carrier), K, sample_rate, L, jnp.float32(1.0)
    )

    wsyms = min(r_local * L - 1, 256)
    wrows = -(-(wsyms + 1) // L)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
    )
    def _shard_demod(x_local, T_, tables_):
        xr = x_local.reshape(r_local, LS)
        head = x_local[:S]
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(head[None], DATA_AXIS, perm)[0]
        nxt = jnp.concatenate([xr[1:, :S], halo[None]], axis=0)
        rows_ov = jnp.concatenate([xr, nxt], axis=1)  # (r_local, LS+S)

        # Pass 1: this shard's leading window scores every offset; psum
        # combines the shards (per-window gain normalization stays local,
        # exactly like the core's per-window estimate).
        w = rows_ov[:wrows]
        flat_w = jnp.concatenate([w[:, :LS].reshape(-1), w[-1, LS:]])
        xw = flat_w[: wsyms * S].reshape(wsyms, S)
        xw_next = flat_w[S : (wsyms + 1) * S].reshape(wsyms, S)
        projw = (
            jnp.matmul(xw, T_[:S], precision=matmul_precision())
            + jnp.matmul(xw_next, T_[S:], precision=matmul_precision())
        ).reshape(wsyms, n_offsets, K, 2)
        rew, imw = projw[..., 0], projw[..., 1]
        gains_w = jnp.sqrt(jnp.mean(rew**2 + imw**2, axis=0)) + 1e-9
        rew, imw = rew / gains_w[None], imw / gains_w[None]
        d_re_w = rew[1:] * rew[:-1] + imw[1:] * imw[:-1]
        d_im_w = imw[1:] * rew[:-1] - rew[1:] * imw[:-1]
        a, b = d_re_w * d_re_w, d_im_w * d_im_w
        local_score = jnp.sum(((a - b) ** 2 - 4 * a * b) / (a + b + 1e-20), axis=(0, 2))
        score = jax.lax.psum(local_score, DATA_AXIS)
        best = jnp.argmax(score)
        off = best * S // n_offsets

        # Pass 2 + boundary differential.
        proj = jnp.matmul(rows_ov, tables_[off], precision=matmul_precision())  # (r_local, 2*L*K)
        re = proj[:, :LK].reshape(-1)
        im = proj[:, LK:].reshape(-1)
        nb = jnp.concatenate([re[:K], im[:K]])  # first symbol -> left neighbor
        nb = jax.lax.ppermute(nb[None], DATA_AXIS, perm)[0]
        re_n = jnp.concatenate([re[K:], nb[:K]])
        im_n = jnp.concatenate([im[K:], nb[K:]])
        dr = re_n * re + im_n * im
        di = im_n * re - re_n * im

        swap = jnp.abs(di) > jnp.abs(dr)
        neg = jnp.where(swap, di < 0, dr < 0)
        hi = neg.astype(jnp.uint8)
        lo = jnp.where(swap, ~neg, neg).astype(jnp.uint8)
        return hi, lo

    x_dev = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))  # host -> shards
    return _shard_demod(x_dev, T, tables)


def demod_hell_capture_sharded(
    samples: np.ndarray,
    baud: float,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
    threshold: float = 0.1,
) -> jnp.ndarray:
    """Hellschreiber pixel detection of ONE capture, sample axis sharded.

    The cross-shard couplings are NIL BY CONSTRUCTION: shards are padded to
    whole pixel windows (spp samples each), and pixel-energy detection
    (ops/hell._pixel_energies — a per-window mean-square) never looks across
    a window boundary, so no halo exchange is needed; glyph segmentation
    (sync-run skip + 7×7 block matching) runs on the host over the gathered
    logically-global pixel stream, which is spp× reduced (~784× at the
    122.5 Bd default). Returns the per-pixel on/off stream, still sharded
    on the mesh's data axis."""
    spp = int(round(sample_rate / baud))
    n_dev = int(np.prod(list(mesh.shape.values())))
    n = len(samples)
    pix_local = max(1, -(-(-(-n // spp)) // n_dev))
    L = pix_local * spp
    x = np.zeros(n_dev * L, dtype=np.float32)
    x[:n] = samples[: n_dev * L]

    @functools.partial(
        shard_map, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS)
    )
    def _shard_pixels(x_local: jnp.ndarray) -> jnp.ndarray:
        w = x_local.reshape(pix_local, spp)
        energy = jnp.mean(w * w, axis=1)
        return (energy > threshold).astype(jnp.uint8)

    x_dev = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))  # host -> shards
    return _shard_pixels(x_dev)


def demod_neural_capture_sharded(
    samples: np.ndarray,
    symbol_rate: int,
    mesh: Mesh,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """NEURAL demod of ONE capture, sample axis sharded over ``mesh``.

    Cross-shard couplings, each handled explicitly:

    * **Distributed matched-filter sync** — every shard runs the preamble
      time-domain correlation (ops/neural._td_corr — the blocked-matmul
      matched filter) over ITS OWN lag span with a halo of
      preamble+symbol samples from the right neighbor (one ``ppermute``),
      so a preamble anywhere in the capture — including straddling a shard
      boundary — is found. An ``all_gather`` of the local peak magnitudes
      picks the global winner; its lag and channel phasor broadcast via
      masked ``psum``. (The batched path limits sync to a capture PREFIX
      for cost; here the search is naturally distributed, so the full-lag
      sweep costs each shard only its slice.)
    * **Chip-grid alignment** — shard length is a multiple of the symbol
      span (8 chips × chip_len, itself a multiple of 4 so the fs/4 sign-
      mask downconversion pattern stays aligned per shard), so the traced
      start offset ``k0 mod spsym`` is IDENTICAL on every shard and each
      shard extracts exactly ``L/spsym`` symbols — consecutive shards'
      symbol streams concatenate to the global stream with no gaps.

    Returns ``(symbols, k0)``: per-position byte symbols still sharded on
    the data axis, and the replicated global sync lag. Symbol ``q + 32``
    onward (q = k0 // spsym) is the framed payload byte stream; the FBPC
    parser's magic scan absorbs the lead garbage, so callers can also just
    parse ``bytes(symbols)`` directly."""
    from ..ops.neural import (
        CHIPS_PER_SYMBOL,
        _chip_len,
        _codebook,
        _corr_table,
        _td_corr,
        _td_peak,
    )

    chip_len = _chip_len(int(symbol_rate))
    spsym = CHIPS_PER_SYMBOL * chip_len
    n_dev = int(np.prod(list(mesh.shape.values())))
    corr_t = jnp.asarray(_corr_table(chip_len))
    P_pre = int(corr_t.shape[0] - 128)
    cb = jnp.asarray(_codebook())

    # Shard length: a multiple of lcm(spsym, 128) — 128 for the correlation
    # row grid, spsym for the uniform chip-grid alignment (spsym is even,
    # so the fs/4 pattern alignment is implied).
    lcm = spsym * 128 // math.gcd(spsym, 128)
    n = len(samples)
    L = max(lcm, -(-(-(-n // lcm)) // n_dev) * lcm)
    x = np.zeros(n_dev * L, dtype=np.float32)
    x[:n] = samples[: n_dev * L]
    ns = L // spsym
    halo_len = -(-(P_pre + spsym) // 4) * 4  # keep the osc pattern aligned

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=(P(DATA_AXIS), P()),
    )
    def _shard_demod(x_local: jnp.ndarray):
        # fs/4 downconversion by sign masks; g0 = idx*L ≡ 0 (mod 4), so the
        # local pattern equals the global one on every shard AND on the halo.
        nl = x_local.shape[0]
        osc_c = jnp.tile(jnp.asarray([1.0, 0.0, -1.0, 0.0], jnp.float32), -(-nl // 4))[:nl]
        osc_s = jnp.tile(jnp.asarray([0.0, -1.0, 0.0, 1.0], jnp.float32), -(-nl // 4))[:nl]
        zr = x_local * osc_c
        zi = x_local * osc_s

        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(
            jnp.stack([zr[:halo_len], zi[:halo_len]])[None], DATA_AXIS, perm
        )[0]
        zre = jnp.concatenate([zr, halo[0]])
        zie = jnp.concatenate([zi, halo[1]])

        # Distributed matched filter: local lags [0, L) with the halo
        # covering windows that extend past the shard.
        cre, cim = _td_corr(zre, zie, corr_t, L // 128)
        k0_l, pr_l, pi_l, pk_l = _td_peak(cre, cim)

        idx = jax.lax.axis_index(DATA_AXIS)
        pk_all = jax.lax.all_gather(pk_l, DATA_AXIS)
        win = jnp.argmax(pk_all)
        mine = (idx == win).astype(jnp.float32)
        k0 = jax.lax.psum(jnp.where(idx == win, k0_l + idx * L, 0), DATA_AXIS)
        pr = jax.lax.psum(pr_l * mine, DATA_AXIS)
        pi = jax.lax.psum(pi_l * mine, DATA_AXIS)

        # Uniform extraction: s0 = k0 mod spsym is shard-invariant (L is a
        # multiple of spsym), so each shard yields exactly ns symbols and
        # the gathered stream is gap-free.
        s0 = jnp.mod(k0, spsym)
        zr_s = jax.lax.dynamic_slice(zre, (s0,), (ns * spsym,))
        zi_s = jax.lax.dynamic_slice(zie, (s0,), (ns * spsym,))
        wr = zr_s * pr + zi_s * pi  # z · conj(phase)
        wi = zi_s * pr - zr_s * pi
        cr = wr.reshape(ns, CHIPS_PER_SYMBOL, chip_len).mean(-1)
        ci = wi.reshape(ns, CHIPS_PER_SYMBOL, chip_len).mean(-1)
        rx = jnp.concatenate([cr, ci], axis=-1)  # (ns, 16)
        scores = jnp.matmul(rx, cb.T, precision=matmul_precision())
        sym = jnp.argmax(scores, axis=-1).astype(jnp.uint8)
        return sym, k0

    x_dev = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))  # host -> shards
    return _shard_demod(x_dev)


def decode_capture_sharded(
    samples: np.ndarray,
    mode: str,
    symbol_rate: int,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
) -> bytes:
    """Full sequence-parallel receive: sharded demod, then sync+pack on the
    logically-global bit array. Covers all 7 shardable families: PSK
    (incl. D8PSK), DSSS, FSK, OFDM, NEURAL, and the text modes (HELL —
    which returns decoded TEXT bytes, like the batched text path)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from ..ops.common import dibit_sync_and_pack, find_bit_pattern, pack_bits_from
    from .batch import resolve_demod_plan

    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "fsk":
        baud_f, mark, space = params
        bits = demod_fsk_capture_sharded(
            samples, baud_f, mark, space, mesh, sample_rate=sample_rate
        )
        with mesh:
            start, _found = jax.jit(
                lambda b: find_bit_pattern(b, MAGIC_BIT_PATTERN)
            )(bits)
            packed, n_valid = jax.jit(pack_bits_from)(bits, start)
        return bytes(np.asarray(packed)[: int(n_valid)])
    if kind == "ofdm":
        baud_o, carrier_o, n_sub = params
        hi, lo = demod_ofdm_capture_sharded(
            samples, baud_o, carrier_o, int(n_sub), mesh, sample_rate=sample_rate
        )
        with mesh:
            packed, n_valid, _found = jax.jit(
                lambda h, l: dibit_sync_and_pack(h, l, MAGIC_BIT_PATTERN)
            )(hi, lo)
        return bytes(np.asarray(packed)[: int(n_valid)])
    if kind == "psk8":
        # Sharded front end at 8th-power timing consensus; rotation estimate,
        # sector decisions, and the 8-hypothesis sync run jitted on the
        # logically-global differential streams (GSPMD inserts the boundary
        # comms — the streams are 8x sample-reduced, so this tail is cheap).
        from ..ops.psk import (
            derotate,
            estimate_common_rotation_windows,
            psk8_sector_stream,
            psk8_sync_and_pack_rotations,
        )

        baud, carrier = params
        d_re, d_im = demod_capture_sharded(
            samples, baud, carrier, mesh, n_psk=8, sample_rate=sample_rate
        )

        @jax.jit
        def _tail8(dr, di):
            th = estimate_common_rotation_windows(dr, di, n_psk=8)
            dr, di = derotate(dr, di, th)
            sec = psk8_sector_stream(dr, di)
            return psk8_sync_and_pack_rotations(
                sec, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
            )

        with mesh:
            packed, n_valid, _found = _tail8(d_re, d_im)
        return bytes(np.asarray(packed)[: int(n_valid)])
    if kind == "dsss":
        # Sharded CHIP front end (raw phasors — chips must sum coherently per
        # data bit before any differential); despread + alignment consensus +
        # DBPSK rotation sync run jitted on the global chip stream, which is
        # spsym-reduced (80x at the default config) so the banded despread
        # matmul and the bit-rate tail are negligible next to the front end.
        from ..ops.common import bit_sync_and_pack_rotations
        from ..ops.dsss import _despread_all_batch
        from ..ops.psk import (
            _coherence_score,
            derotate,
            estimate_common_rotation,
        )

        baud, carrier = params
        re_f, im_f = demod_capture_sharded(
            samples, baud, carrier, mesh, n_psk=2, sample_rate=sample_rate, raw=True
        )

        @jax.jit
        def _tail_dsss(re_f, im_f):
            b_re = _despread_all_batch(re_f[None])[0]  # (16, n_bits)
            b_im = _despread_all_batch(im_f[None])[0]
            d_re = b_re[:, 1:] * b_re[:, :-1] + b_im[:, 1:] * b_im[:, :-1]
            d_im = b_im[:, 1:] * b_re[:, :-1] - b_re[:, 1:] * b_im[:, :-1]
            a = jnp.argmax(_coherence_score(d_re, d_im, axis=1))
            dr, di = d_re[a], d_im[a]
            dr, di = derotate(dr, di, estimate_common_rotation(dr, di))
            return bit_sync_and_pack_rotations(
                (dr < 0).astype(jnp.uint8),
                (di < 0).astype(jnp.uint8),
                MAGIC_BIT_PATTERN,
                MAGIC_BIT_PATTERN2,
            )

        with mesh:
            packed, n_valid, _found = _tail_dsss(re_f, im_f)
        return bytes(np.asarray(packed)[: int(n_valid)])
    if kind == "hell":
        (baud_h,) = params
        pixels = demod_hell_capture_sharded(
            samples, baud_h, mesh, sample_rate=sample_rate
        )
        from ..ops.hell import _decode_blocks

        return _decode_blocks(np.asarray(pixels)).encode("utf-8", "replace")
    if kind == "neural":
        (rate_n,) = params
        syms, _k0 = demod_neural_capture_sharded(samples, int(rate_n), mesh)
        # The symbol stream IS bytes (1 byte/symbol); the FBPC parser's
        # magic scan absorbs the pre-preamble lead and the preamble itself.
        return bytes(np.asarray(syms))
    if kind not in ("psk2", "psk4"):
        raise ValueError(
            f"sequence-parallel decode supports PSK/8PSK/DSSS/FSK/OFDM/NEURAL/HELL modes, not {mode}"
        )
    baud, carrier = params

    d_re, d_im = demod_capture_sharded(
        samples, baud, carrier, mesh, n_psk=4 if kind == "psk4" else 2,
        sample_rate=sample_rate,
    )
    with mesh:
        if kind == "psk4":
            hi, lo = jax.jit(qpsk_gray_streams)(d_re, d_im)
            packed, n_valid, _found = jax.jit(
                lambda h, l: dibit_sync_and_pack(h, l, MAGIC_BIT_PATTERN)
            )(hi, lo)
        else:
            bits = jax.jit(lambda d: (d < 0).astype(jnp.uint8))(d_re)
            start, _found = jax.jit(
                lambda b: find_bit_pattern(b, MAGIC_BIT_PATTERN)
            )(bits)
            packed, n_valid = jax.jit(pack_bits_from)(bits, start)
    return bytes(np.asarray(packed)[: int(n_valid)])
