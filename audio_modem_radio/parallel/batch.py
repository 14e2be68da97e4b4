"""Batched, sharded demodulation of many captures — the throughput layer.

This is the point of the rebuild (BASELINE.json north star): thousands of
recorded WAVs decode in parallel per device. The pipeline:

  host: read/resample/pad WAVs to one bucket length  ->  (B, N) float32
  device: vmapped demod (PSK projection matmuls / FSK filter bank),
          sharded over the mesh data axis; bit->byte packing and magic
          sync also run on device, vmapped
  host: FBPC frame parse + decompression + assembly per capture (cheap,
        byte-level)

The per-mode bit-level demodulators are the same jitted functions the
single-file path uses; ``jax.vmap`` lifts them over the batch and
``NamedSharding`` over a 1-D mesh splits the batch across devices — XLA inserts
no collectives because captures are independent.
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..assembly import AssemblyRegistry
from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from ..modem import SAMPLE_RATE
from ..config import CONFIG
from ..ops.common import (
    bit_sync_and_pack_rotations,
    dibit_sync_and_pack,
    dibit_sync_and_pack_rotations,
    find_bit_pattern,
    find_bit_pattern_validated,
    pack_bits_from,
)
from ..ops.fsk import fsk_demod_bits
from ..ops.ofdm import ofdm_decision_streams_batch
from ..ops.psk import psk_decision_streams_batch
from ..utils.wavio import read_wav, resample
from .mesh import batch_sharding, get_mesh, pad_batch

logger = logging.getLogger("audio_modem_radio")

# --- per-mode demodulator plan -------------------------------------------------

def resolve_demod_plan(mode: str, symbol_rate: int) -> Tuple[str, tuple]:
    """Mode name -> ('psk2'|'psk4'|'fsk'|'ofdm'|'neural'|'hell', params) for
    the batched hot path. Mirrors the dispatch/aliasing of the mode registry
    (modem.py). The text modes batch as glyph-template matmuls ('hell',
    params = (pixel baud,)) and yield TEXT bytes, not an FBPC byte stream.
    """
    r = symbol_rate
    table = {
        "FSK1200": ("fsk", (1200.0, 1200.0, 2200.0)),
        "FSK9600": ("fsk", (9600.0, 1200.0, 2200.0)),
        "FSK19200": ("fsk", (19200.0, 8000.0, 16000.0)),
        "BPSK": ("psk2", (float(r), 3000.0)),
        "QPSK": ("psk4", (float(r), 3000.0)),
        "8PSK": ("psk8", (float(r), 12000.0)),
        "OFDM4": ("ofdm", (float(r), 12000.0, 4)),
        "OFDM8": ("ofdm", (float(r), 12000.0, 8)),
        "APSK16": ("psk4", (float(r), 12000.0)),
        "SSTV": ("psk4", (float(r), 3000.0)),
        "DSSS": ("dsss", (float(r), 3000.0)),
        "MSK": ("fsk", (float(r), 6000.0, 6000.0 + r)),
        "FT8": ("fsk", (50.0, 3000.0, 3050.0)),
        "PSK31": ("psk2", (31.25, 3000.0)),
        "NEURAL": ("neural", (float(r),)),
        "HELLSCHREIBER": ("hell", (122.5,)),
        "FELD_HELL": ("hell", (122.5,)),
        "SLOW_HELL": ("hell", (61.25,)),
    }
    if mode not in table:
        return table["QPSK"]  # unknown-mode fallback, like the reference decoder
    return table[mode]


# --- device-side batched demod -------------------------------------------------

def _dibit_sync_tail(hi, lo, cfo_retry: bool):
    """Vmapped DQPSK/OFDM sync tail over (B, n) Gray dibit lanes: the
    validated magic search under all four quarter-turn relabelings (or only
    the unrotated one when ``cfo_retry`` is off — a rotated stream must NOT
    silently decode), then one byte pack on the winner."""
    sync = dibit_sync_and_pack_rotations if cfo_retry else dibit_sync_and_pack
    return jax.vmap(
        lambda h, l: sync(h, l, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    )(hi, lo)


def _psk8_sync_tail(sec, cfo_retry: bool):
    """Vmapped D8PSK sync tail over (B, m) π/4 sector streams: the validated
    magic search under all eight rotation hypotheses, or only the unrotated
    one when ``cfo_retry`` is off."""
    from ..ops.psk import psk8_sync_and_pack_rotations

    n_rot = 8 if cfo_retry else 1
    return jax.vmap(
        lambda s: psk8_sync_and_pack_rotations(
            s, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, n_rotations=n_rot
        )
    )(sec)


@functools.partial(
    jax.jit, static_argnames=("mode", "symbol_rate", "cfo_retry", "fsk_mlse")
)
def demod_pack_batch(
    samples: jnp.ndarray,
    mode: str,
    symbol_rate: int,
    cfo_retry: bool = True,
    fsk_mlse: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(B, N) samples -> (packed_bytes (B, max_bytes), n_valid (B,), found (B,)).

    One fused jitted program: demod + magic sync + byte packing, vmapped over
    the batch. Shard the input's leading axis to run data-parallel. QPSK-family
    modes stay in dual (hi, lo) dibit streams end to end — the interleaved bit
    array is never materialized.

    PSK-family modes also accept pre-shaped (B, rows, 128*spsym) input (see
    ``ops.psk.blocked_row_shape``): shaping rows on the host spares the
    device a pad+reshape pass. ``decode_sample_batch`` does this
    automatically.
    """
    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "ofdm" and CONFIG.get("modem.ofdm_compat_alias", False):
        kind, params = "psk4", (params[0], params[1])
    if kind == "psk8" and CONFIG.get("modem.psk8_compat_alias", False):
        kind = "psk4"  # alias wire format IS DQPSK at the same carrier
    if kind == "dsss" and CONFIG.get("modem.dsss_compat_alias", False):
        kind = "psk2"  # alias wire format IS plain DBPSK

    if kind == "dsss":
        # Real spread spectrum (ops/dsss.py): the blocked batch chip front
        # end (shared with the PSK family, raw phasors) + one banded despread
        # matmul + the DBPSK sync tail vmapped on the 16x-reduced bit stream.
        from ..ops.dsss import dsss_bits_cfo_batch

        baud, carrier = params
        return dsss_bits_cfo_batch(
            samples, baud, carrier, SAMPLE_RATE, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
        )

    if kind == "psk8":
        # Real D8PSK (ops/psk.py): the shared blocked projection/differential
        # front end at 8th-power timing scores, blind derotation, elementwise
        # π/4-sector decisions, then the 8-hypothesis rotation sync tail.
        from ..ops.psk import psk8_sector_rows_batch

        baud, carrier = params
        sec = psk8_sector_rows_batch(
            samples, baud, carrier, SAMPLE_RATE, cfo=cfo_retry
        )
        return _psk8_sync_tail(sec, cfo_retry)

    if kind == "neural":
        # Learned-codebook detection IS a batched matmul already; symbols are
        # bytes, so no bit-level sync/pack stage exists for this mode.
        from ..ops.neural import (
            CHIPS_PER_SYMBOL,
            PREAMBLE_LEN,
            _chip_len,
            _codebook,
            _demod,
            _preamble_spectra,
            _td_supported,
            demod_td_batch,
        )

        chip_len = _chip_len(int(params[0]))
        if _td_supported(chip_len):
            # All-matmul time-domain path: blocked correlation sync +
            # aligned chip-table extraction. The sync search is
            # prefix-limited with all-capture consensus escalation (the
            # correlation matmul over every lag was half the NEURAL FLOPs).
            syms = demod_td_batch(samples, chip_len)
            payload = syms[:, PREAMBLE_LEN:]
            b = payload.shape[0]
            return (
                payload,
                jnp.full((b,), payload.shape[1], jnp.int32),
                jnp.ones((b,), bool),
            )

        n_fft = 1 << int(
            np.ceil(np.log2(samples.shape[-1] + PREAMBLE_LEN * CHIPS_PER_SYMBOL * chip_len))
        )
        pre_fr, pre_fi = _preamble_spectra(chip_len, n_fft)
        cb = jnp.asarray(_codebook())
        fr_j, fi_j = jnp.asarray(pre_fr), jnp.asarray(pre_fi)

        def neural_one(x):
            syms, _k0 = _demod(x, cb, fr_j, fi_j, chip_len, n_fft)
            payload = syms[PREAMBLE_LEN:]
            return payload, jnp.asarray(payload.shape[0]), jnp.asarray(True)

        return jax.vmap(neural_one)(samples)

    if kind == "hell":
        # Text fax: glyph classification is one (B, n_blocks, 49) @ (49, 95)
        # matmul + argmax — the "packed bytes" are ASCII char codes, not an
        # FBPC byte stream (decode_wav_batch saves them as .txt).
        from ..ops.hell import hell_demod_text_batch

        spp = int(round(SAMPLE_RATE / params[0]))
        return hell_demod_text_batch(samples, spp)

    if kind in ("psk4", "psk2"):
        baud, carrier = params
        # Decision streams (ops/psk.py): projection + differential + blind
        # per-capture derotation + Gray/sign decision. The residual k·π/2
        # sector ambiguity of the blind CFO estimate is resolved by matching
        # the frame magic under all four quarter-turn relabelings and
        # byte-packing ONCE on the winning rotation (ops/common.py rotation
        # sync). Channels known to be carrier-exact (e.g. digital loopback
        # farms) can pass cfo_retry=False (decode_sample_batch plumbs CONFIG
        # modem.cfo_retry) to skip the rotation machinery.
        n_psk = 4 if kind == "psk4" else 2
        hi, lo = psk_decision_streams_batch(
            samples, baud, carrier, SAMPLE_RATE, n_psk=n_psk, cfo=cfo_retry,
        )
        if kind == "psk4":
            return _dibit_sync_tail(hi, lo, cfo_retry)
        # psk2: (hi, lo) are the (re, im) sign-bit streams.
        if cfo_retry:
            return jax.vmap(
                lambda br, bi: bit_sync_and_pack_rotations(br, bi, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
            )(hi, lo)

        def sync_pack_one(bb):
            start, found = find_bit_pattern_validated(
                bb, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
            )
            packed, n_valid = pack_bits_from(bb, start)
            return packed, n_valid, found

        return jax.vmap(sync_pack_one)(hi)

    if kind == "ofdm":
        # OFDM dibits are Gray pairs with the same k*pi/2 relabeling algebra
        # as DQPSK, so the dual (hi, lo) streams feed the IDENTICAL sync
        # tail; the interleaved bit array is never built.
        baud, carrier, n_sub = params
        hi, lo = ofdm_decision_streams_batch(
            samples, baud, carrier, int(n_sub), SAMPLE_RATE, cfo=cfo_retry
        )
        return _dibit_sync_tail(hi, lo, cfo_retry)

    # Batched FSK skips MLSE refinement by default (fsk_mlse=False): the
    # trellis scan costs ~3x pipeline throughput and the equalizer's ~1.5e-5
    # floor is already far below frame-loss relevance on production captures;
    # precision decodes (the single-file path) still run MLSE with parse-
    # verified fallback. fsk_mlse is a STATIC jit arg so the knob always
    # takes effect (decode_sample_batch plumbs CONFIG modem.batch_mlse).

    # Dual-tone captures pre-overlapped by host shaping run the batched
    # pass-1 + one-einsum path (fsk_dual_bits_rows_batch). Close/mid-tone
    # captures arrive as the matmul FIR front end's pre-shaped windows
    # (fsk_fir_row_shape), which fsk_demod_bits consumes directly.
    # Everything else stays the vmapped flat-capture pipeline.
    baud, mark, space = params
    from ..ops.fsk import (
        _fsk_geometry,
        _samples_per_bit,
        _separation_cycles,
        fsk_dual_bits_rows_batch,
    )

    sep = _separation_cycles(baud, mark, space, SAMPLE_RATE)
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    if samples.ndim == 3 and sep >= 0.8:
        _spr, row, ov = _fsk_geometry(spb)
        if samples.shape[2] == row + ov:
            bits = fsk_dual_bits_rows_batch(samples, baud, mark, space, SAMPLE_RATE)
        else:
            raise ValueError("pre-shaped dual-tone rows have the wrong column count")
    else:
        def to_bits(x):
            return fsk_demod_bits(x, baud, mark, space, SAMPLE_RATE, mlse=fsk_mlse)[0]

        bits = jax.vmap(to_bits)(samples)

    def sync_pack(bb):
        start, found = find_bit_pattern(bb, MAGIC_BIT_PATTERN)
        packed, n_valid = pack_bits_from(bb, start)
        return packed, n_valid, found

    return jax.vmap(sync_pack)(bits)


# --- host orchestration --------------------------------------------------------

def _bucket_length(lengths: Sequence[int]) -> int:
    from ..decoder import pad_to_bucket  # reuse the bucket table

    probe = np.zeros(max(lengths), dtype=np.float32)
    return len(pad_to_bucket(probe))


def host_shape_batch(
    batch: np.ndarray, mode: str, symbol_rate: int,
    fsk_mlse: Optional[bool] = None,
) -> np.ndarray:
    """Pre-shape (B, N) captures into the layout ``demod_pack_batch`` wants.

    PSK-family captures become blocked (B, r, 128*spsym) rows and dual-tone
    FSK captures become pre-overlapped (B, r, row+ov) rows — both with cheap
    numpy views, so the device never pays a pad+reshape pass for them.
    Other mode families pass through unchanged.

    Rows ship as float32 unless CONFIG ``device.int16_rows`` (int16 at scale
    32768, exact for int16-PCM sources) or ``device.int8_rows`` asks for a
    narrower PSK/HELL transfer.

    ``fsk_mlse`` overrides CONFIG ``modem.batch_mlse`` for the FSK row-shape
    decision (MLSE correlates the RAW samples, so an MLSE dispatch must keep
    flat (B, N) input); None defers to CONFIG.
    """
    batch = np.asarray(batch, dtype=np.float32)
    b = batch.shape[0]

    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "psk8" and CONFIG.get("modem.psk8_compat_alias", False):
        kind = "psk4"  # demod_pack_batch applies the same rewrite
    if kind == "dsss" and CONFIG.get("modem.dsss_compat_alias", False):
        kind = "psk2"
    if kind in ("psk2", "psk4", "psk8", "dsss"):
        from ..ops.psk import blocked_row_shape

        shape = blocked_row_shape(batch.shape[1], params[0], SAMPLE_RATE)
        if shape is not None:
            r, row = shape
            keep = min(batch.shape[1], r * row)
            # DSSS runs a float-stream front end (psk_raw_streams_batch), so
            # its rows always ship as f32.
            narrow = kind != "dsss"
            if narrow and CONFIG.get("device.int8_rows", False):
                # Opt-in: quarters the h2d transfer. ~-50 dB quantization
                # noise — negligible against any channel this modem operates
                # in, but NOT bit-exact to int16-PCM sources.
                shaped = np.zeros((b, r * row), dtype=np.int8)
                shaped[:, :keep] = np.clip(
                    np.round(batch[:, :keep] * 128.0), -128, 127
                ).astype(np.int8)
            elif narrow and CONFIG.get("device.int16_rows", False):
                # Halves the h2d transfer; the einsum front end casts to f32.
                # Scale 32768 reproduces int16-PCM sources exactly (read_wav
                # divides by 32768); other sources requantize ~-90 dB below
                # full scale.
                shaped = np.zeros((b, r * row), dtype=np.int16)
                shaped[:, :keep] = np.clip(
                    np.round(batch[:, :keep] * 32768.0), -32768, 32767
                ).astype(np.int16)
            else:
                shaped = np.zeros((b, r * row), dtype=np.float32)
                shaped[:, :keep] = batch[:, :keep]
            batch = shaped.reshape(b, r, row)
    elif kind == "fsk":
        from ..ops.fsk import fsk_blocked_row_shape, fsk_fir_row_shape

        baud, mark, space = params
        shape = fsk_blocked_row_shape(batch.shape[1], baud, mark, space, SAMPLE_RATE)
        if shape is not None:
            # Dual-tone path: pre-overlapped (r, row+ov) rows built with two
            # numpy strided views instead of a device-side pad+reshape+concat.
            batch = _overlap_rows(batch, *shape)
        elif not (
            bool(CONFIG.get("modem.batch_mlse", False)) if fsk_mlse is None
            else fsk_mlse
        ):
            # Close/mid-tone configs (FSK9600/FSK19200): pre-shape the matmul
            # FIR front end's overlapped input windows instead — the same
            # relayout the device otherwise builds inside
            # analytic_bandpass_fir_dec. MLSE refinement needs the raw flat
            # samples, so the (non-default) batch_mlse config keeps (B, N).
            fshape = fsk_fir_row_shape(batch.shape[1], baud, mark, space, SAMPLE_RATE)
            if fshape is not None:
                r, rowl, ov, lead = fshape
                batch = _overlap_rows(batch, r, rowl, ov, lead=lead)
    elif kind == "ofdm":
        from ..ops.ofdm import ofdm_blocked_row_shape

        baud, carrier, n_sub = params
        shape = ofdm_blocked_row_shape(batch.shape[1], baud, int(n_sub), SAMPLE_RATE)
        if shape is not None:
            # Same treatment as dual-tone FSK: the overlapped rows are
            # offset-independent (pass 2 selects a row-shifted weight table),
            # so the row build is host strided views, not a device relayout.
            batch = _overlap_rows(batch, *shape)
    elif kind == "hell":
        # Text fax: ship (B, n_pix, spp) pixel windows — a free numpy view
        # (pixel windows tile the capture exactly, no overlap). int16 rows
        # halve the ship; the square-reduce rescales.
        spp = int(round(SAMPLE_RATE / params[0]))
        n_pix = batch.shape[1] // spp
        if n_pix >= 1:
            view = batch[:, : n_pix * spp].reshape(b, n_pix, spp)
            if CONFIG.get("device.int16_rows", False):
                batch = np.clip(np.round(view * 32768.0), -32768, 32767).astype(
                    np.int16
                )
            else:
                batch = view
    return batch


def _overlap_rows(
    batch: np.ndarray, r: int, row: int, ov: int, lead: int = 0
) -> np.ndarray:
    """(B, N) -> (B, r, row+ov) float32 overlapped rows via two strided views.

    ``lead`` zero-samples are logically prepended first (the FIR front end's
    center-tap alignment) without materializing the concatenation."""
    if ov > row:
        raise ValueError("overlap must not exceed the row length")
    b = batch.shape[0]
    keep = min(batch.shape[1], r * row + ov - lead)
    flat = np.zeros((b, (r + 1) * row), dtype=np.float32)
    flat[:, lead : lead + keep] = batch[:, :keep]
    shaped = np.empty((b, r, row + ov), dtype=np.float32)
    shaped[:, :, :row] = flat[:, : r * row].reshape(b, r, row)
    shaped[:, :, row:] = flat[:, row : (r + 1) * row].reshape(b, r, row)[:, :, :ov]
    return shaped


def decode_sample_batch(
    batch: np.ndarray,
    mode: str,
    symbol_rate: int,
    mesh=None,
    fsk_mlse: Optional[bool] = None,
) -> List[bytes]:
    """Demodulate a (B, N) batch to per-capture raw byte streams.

    When a mesh (or more than one device) is available the batch axis is
    sharded across it. PSK-family captures are pre-shaped into blocked rows
    on the host (cheap numpy) so the device never pays the pad+reshape
    relayout. ``fsk_mlse`` overrides CONFIG ``modem.batch_mlse`` (used by
    the MLSE escalation in ``decode_wav_batch``); None defers to CONFIG.
    """
    batch = host_shape_batch(batch, mode, symbol_rate, fsk_mlse=fsk_mlse)
    b = batch.shape[0]

    if mesh is None and len(jax.devices()) > 1:
        mesh = get_mesh()
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
        padded = pad_batch(batch, n_dev)
        # Shard straight from host memory: each device receives only its
        # slice, so no batch is staged whole on the first device.
        x = jax.device_put(padded, batch_sharding(mesh))
    else:
        x = jax.device_put(batch)

    packed, n_valid, _found = demod_pack_batch(
        x,
        mode,
        int(symbol_rate),
        cfo_retry=bool(CONFIG.get("modem.cfo_retry", True)),
        fsk_mlse=(
            bool(CONFIG.get("modem.batch_mlse", False)) if fsk_mlse is None
            else bool(fsk_mlse)
        ),
    )
    packed = np.asarray(packed)[:b]
    n_valid = np.asarray(n_valid)[:b]
    return [packed[i, : int(n_valid[i])].tobytes() for i in range(b)]


def _read_wav_row(path: str) -> np.ndarray:
    """Read one WAV for the batch, resampled to 96 kHz; a corrupt file
    yields an EMPTY row instead of raising — one truncated WAV in a
    1000-file batch must not lose the other 999 (the native loader's
    rate==0 'failed to parse' marker lands here too)."""
    try:
        data, sr = read_wav(path)
        if sr != SAMPLE_RATE:
            data = resample(data, sr, SAMPLE_RATE)
        return data.astype(np.float32)
    except Exception:
        logger.exception("unreadable WAV in batch: %s", path)
        return np.zeros(0, np.float32)


def decode_wav_batch(
    paths: Sequence[str],
    mode: str,
    symbol_rate: int,
    recv_dir: str = "recv",
    registry: Optional[AssemblyRegistry] = None,
    mesh=None,
    stream_fec: bool = False,
    denoise: Optional[bool] = None,
    drift_retry: bool = True,
) -> List[List[str]]:
    """Decode many WAV files in one sharded device batch.

    Returns, per input WAV, the list of file paths recovered from it.
    Frames from all captures feed one assembly registry, so a multi-part
    transfer spread across several captures reassembles here.

    WAV loading goes through the native multi-threaded loader when the C++
    library is available (one Python ``wave`` parse per file is the host
    bottleneck at 1000-file batches); frame scanning likewise.

    The throughput path carries the FULL single-capture robustness ladder
    (round 2 recovered strictly less than ``decode_from_buffer`` on damaged
    input): per capture — optional spectral-gate ``denoise`` (None defers to
    CONFIG ``modem.noise_reduction``), optional ``stream_fec`` Viterbi decode
    with soft-decision escalation, strict parse + damaged-frame FEC +
    header-tolerant recovery, the no-sync rescue sweep on total loss, and
    finally the ±5% clock-drift hypotheses (``drift_retry``) — failed
    captures only, resampled into ONE extra batched dispatch (they are just
    extra batch rows, not sequential retries; decoder.decode_with_retry's
    exact-inverse stride math).
    """
    from ..decoder import default_registry, save_decoded_files
    from ..native import NATIVE_AVAILABLE, load_wav_batch

    if NATIVE_AVAILABLE:
        # Native loader reads headers + samples in parallel; a probe pass
        # over sizes picks the bucket. Files at non-96k rates fall back to
        # the Python path for resampling.
        import os

        est_len = max(
            (os.path.getsize(p) // 2 for p in paths if os.path.exists(p)), default=1
        )
        row_len = _bucket_length([est_len])
        samples, rates, counts = load_wav_batch(
            list(paths), row_len,
            max_threads=int(CONFIG.get("performance.max_workers", 0)),
        )
        arrays = []
        for i, p in enumerate(paths):
            if rates[i] == SAMPLE_RATE:
                arrays.append(samples[i, : counts[i]])
            else:  # failed or needs resampling: Python path
                arrays.append(_read_wav_row(p))
    else:
        arrays = [_read_wav_row(p) for p in paths]

    if denoise is None:
        denoise = bool(CONFIG.get("modem.noise_reduction", False))
    if denoise:
        from ..utils.denoise import spectral_gate

        arrays = [spectral_gate(a) for a in arrays]

    n = _bucket_length([len(a) for a in arrays])
    batch = np.zeros((len(arrays), n), dtype=np.float32)
    for i, a in enumerate(arrays):
        batch[i, : min(len(a), n)] = a[:n]

    raws = decode_sample_batch(batch, mode, symbol_rate, mesh=mesh)

    if resolve_demod_plan(mode, symbol_rate)[0] == "hell":
        # Text-fax captures: the batched glyph matmul already produced the
        # decoded text (empty when the sync gate rejected the capture); save
        # each as recv_<ts>_<stem>.txt, mirroring decode_from_buffer.
        import os as _os

        from ..decoder import save_decoded_text

        out_txt: List[List[str]] = []
        for i, raw in enumerate(raws):
            text = raw.decode("ascii", "replace")
            if not text.strip():
                out_txt.append([])
                continue
            stem = _os.path.splitext(_os.path.basename(paths[i]))[0]
            out_txt.append([save_decoded_text(text, recv_dir, stem)])
        return out_txt

    reg = registry or default_registry

    def _ladder(raw: bytes, samples_i: np.ndarray, rescue: bool):
        """Single-capture post-demod policy: THE shared
        decoder.run_recovery_ladder (single source of truth with
        decode_from_buffer — VERDICT r4 weak #5 closed: the batch and
        single-file rungs cannot drift because they are the same code)."""
        from ..decoder import run_recovery_ladder

        frames, damaged, total_loss, _counts = run_recovery_ladder(
            raw, samples_i, mode, symbol_rate, stats=reg.stats,
            rescue=rescue, stream_fec=stream_fec,
        )
        return frames, damaged, total_loss

    out: List[List[str]] = []
    lost: List[int] = []
    for i, raw in enumerate(raws):
        frames, damaged, total_loss = _ladder(raw, arrays[i], rescue=True)
        out.append(save_decoded_files(frames, recv_dir, registry, damaged=damaged or None))
        # A capture is "lost" (eligible for the MLSE / clock-drift
        # escalations) when it saved nothing AND produced no CRC-valid
        # frame — damaged-only parses count as lost (a 1-bit name corruption
        # must not mask the escalation), but a valid multi-part frame that
        # entered the assembly without completing it is progress, not loss.
        if not out[-1] and not frames:
            lost.append(i)

    kind, params = resolve_demod_plan(mode, symbol_rate)
    if (
        lost
        and kind == "fsk"
        and not bool(CONFIG.get("modem.batch_mlse", False))
    ):
        from ..ops.fsk import _separation_cycles

        if _separation_cycles(params[0], params[1], params[2], SAMPLE_RATE) < 0.8:
            # MLSE escalation: the batch skips the ~3x-cost trellis
            # refinement by default (the equalizer's ~1.5e-5 floor is below
            # frame-loss relevance on healthy captures), which made a
            # marginal capture the single-file path decodes silently LOST
            # in a batch. Re-dispatch ONLY the captures whose parse found
            # nothing through the MLSE-refined path — overhead stays
            # proportional to the failed fraction, and batch never decodes
            # strictly worse than single-file. (The blanket batch_mlse
            # config remains for pay-up-front workloads.)
            esc = np.zeros((len(lost), batch.shape[1]), dtype=np.float32)
            for j, i in enumerate(lost):
                esc[j, : min(len(arrays[i]), esc.shape[1])] = arrays[i][: esc.shape[1]]
            esc_raws = decode_sample_batch(
                esc, mode, symbol_rate, mesh=mesh, fsk_mlse=True
            )
            still_lost: List[int] = []
            for j, i in enumerate(lost):
                frames, damaged, total_loss = _ladder(
                    esc_raws[j], arrays[i], rescue=True
                )
                saved = save_decoded_files(
                    frames, recv_dir, registry, damaged=damaged or None
                )
                if saved:
                    out[i] = saved
                elif not frames:
                    still_lost.append(i)
            lost = still_lost

    if (
        lost
        and kind in ("psk2", "psk4", "psk8", "ofdm", "dsss")
        and CONFIG.get("modem.psk_coherent_escalation", True)
        and not (kind == "psk8" and CONFIG.get("modem.psk8_compat_alias", False))
        and not (kind == "ofdm" and CONFIG.get("modem.ofdm_compat_alias", False))
        and not (kind == "dsss" and CONFIG.get("modem.dsss_compat_alias", False))
    ):
        # Coherent escalation (the single-file mode-demodulate policy):
        # captures whose differential-detection parse found nothing retry
        # through the Viterbi&Viterbi carrier-tracked receiver — measured ON
        # the coherent bound, recovering the 2.3 dB noisy-reference penalty
        # (PERF.md "Coherent-tracked PSK escalation"); OFDM tracks per
        # subcarrier and DSSS tracks the despread bit stream (round 5 —
        # without these rows a batch OFDM/DSSS capture inside the tracked
        # floors would decode strictly worse than single-file, violating
        # this file's parity invariant). Host-looped over only the failed
        # captures, so overhead stays failure-proportional.
        from ..ops.dsss import dsss_tracked_demodulate
        from ..ops.ofdm import ofdm_tracked_demodulate
        from ..ops.psk import (
            bpsk_tracked_demodulate,
            psk8_tracked_demodulate,
            qpsk_tracked_demodulate,
        )

        tfn = {
            "psk2": bpsk_tracked_demodulate,
            "psk4": qpsk_tracked_demodulate,
            "psk8": psk8_tracked_demodulate,
            "ofdm": lambda s, b, c, sr: ofdm_tracked_demodulate(
                s, b, c, int(params[2]), sr
            ),
            "dsss": dsss_tracked_demodulate,
        }[kind]
        still_lost = []
        for i in lost:
            if len(arrays[i]) < 2 * int(SAMPLE_RATE // params[0]):
                still_lost.append(i)
                continue
            try:
                traw = tfn(arrays[i], params[0], params[1], SAMPLE_RATE)
            except ValueError:
                # Tracked receivers have per-mode minimum-length contracts
                # beyond the generic 2-symbol guard (e.g. OFDM requires
                # three OFDM symbols) — a degenerate capture must stay
                # "lost", not crash the whole batch.
                still_lost.append(i)
                continue
            frames, damaged, _tl = _ladder(traw, arrays[i], rescue=False)
            saved = save_decoded_files(
                frames, recv_dir, registry, damaged=damaged or None
            )
            if saved:
                out[i] = saved
            elif not frames:
                still_lost.append(i)
        lost = still_lost

    if drift_retry and lost:
        # Clock-drift hypotheses for the captures that yielded nothing: rows
        # resampled by the exact inverse stride (decode_with_retry's math),
        # ONE extra batched dispatch covering every (capture, factor) pair.
        from ..decoder import RETRY_FACTORS

        drift = [f for f in RETRY_FACTORS if f != 1.0]
        strides = [1.0 / f for f in drift]
        m = _bucket_length([int(np.ceil(n / min(strides)))])
        retry = np.zeros((len(lost) * len(drift), m), dtype=np.float32)
        for j, i in enumerate(lost):
            a = arrays[i]
            if len(a) < 2:
                continue  # unreadable WAV: empty row, nothing to resample
            src = np.arange(len(a), dtype=np.float64)
            for k, s in enumerate(strides):
                dst = np.arange(int(len(a) / s), dtype=np.float64) * s
                row = np.interp(dst, src, a).astype(np.float32)
                retry[j * len(drift) + k, : min(len(row), m)] = row[:m]
        retry_raws = decode_sample_batch(retry, mode, symbol_rate, mesh=mesh)
        for j, i in enumerate(lost):
            for k in range(len(drift)):
                # The ladder's sample-domain escalations (soft stream-FEC,
                # soft payload-FEC) must see the RESAMPLED row the raw bytes
                # came from — the original capture's soft stream can never
                # align with this hypothesis's byte stream.
                frames, damaged, _tl = _ladder(
                    retry_raws[j * len(drift) + k],
                    retry[j * len(drift) + k],
                    rescue=False,
                )
                if not frames and not damaged:
                    continue
                saved = save_decoded_files(
                    frames, recv_dir, registry, damaged=damaged or None
                )
                if saved or frames:
                    # Accept only a hypothesis with saved files or CRC-proven
                    # frames (a valid multipart part enters the assembly
                    # without saving). A spurious DAMAGED parse from a
                    # garbage stream must NOT end the sweep — it would mask
                    # the correct factor later on (decode_with_retry's
                    # accept-on-saved semantics, decoder.py).
                    out[i] = saved
                    break
    return out
