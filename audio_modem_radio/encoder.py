"""Encode pipeline: file -> compress -> frame -> modulate -> WAV.

Capability parity with the reference encoder (/root/reference/encoder.py):

* ``encode_file`` — single-shot path: read, CRC32, intelligent compression,
  FBPC framing, modulate, write ``cache/<name>.<MODE>.wav`` (encoder.py:260-306).
* ``split_file_for_transmission`` / ``encode_file_parts`` — multi-part path
  with the per-mode efficiency map, 90% payload fill, per-part adaptive
  compression, full mode dispatch, audio verification with the
  BPSK -> test-tone fallback ladder, cancellation, and progress callbacks
  (encoder.py:117-252).
* ``verify_audio_output`` — the 8-point waveform checklist (encoder.py:318-349).
* ``calculate_transmission_stats`` / ``get_encoding_stats`` — duration and
  bitrate estimation (encoder.py:63-91).

Unlike the reference, ``encode_file`` honors its ``split_large_files`` /
``target_duration_min`` / ``progress_callback`` / ``is_cancelled`` arguments
(the reference accepts and ignores them, encoder.py:260-306) and directories
are created lazily instead of at import time.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import threading
from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import CONFIG
from .fec import stream_fec_encode, wrap_fec
from .framing import crc32, pack_frame
from .modem import MODES, SAMPLE_RATE, modulate, wav_from_array
from .ops.psk import bpsk_modulate
from .utils.compression import (
    adaptive_compress,
    compress_data,
    delta_compress,
    intelligent_compress,
    super_compress,
)

logger = logging.getLogger("audio_modem_radio")

CACHE_DIR = "cache"

# (filename, payload, part_number, total_parts, file_size, file_crc)
FilePart = Tuple[str, bytes, int, int, int, int]


def _ensure_cache_dir(cache_dir: str = CACHE_DIR) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


# --- cancellation (event-based instead of the reference's bare global flag) ---

_cancel_event = threading.Event()


def cancel_encoding() -> None:
    _cancel_event.set()


def reset_encoding_cancel() -> None:
    _cancel_event.clear()


def _cancelled(user_cb: Optional[Callable[[], bool]]) -> bool:
    return _cancel_event.is_set() or bool(user_cb and user_cb())


# --- file-signature cache -----------------------------------------------------

@lru_cache(maxsize=50)
def get_file_signature(file_path: str, mode: str, compress: bool, symbol_rate: int) -> str:
    s = os.stat(file_path)
    key = f"{file_path}_{s.st_size}_{s.st_mtime}_{mode}_{compress}_{symbol_rate}"
    return hashlib.md5(key.encode()).hexdigest()


def clear_encoding_cache() -> None:
    get_file_signature.cache_clear()


# --- throughput model ---------------------------------------------------------

def _bytes_per_sec(mode: str, symbol_rate: int) -> float:
    spec = MODES.get(mode)
    if spec is None:
        return symbol_rate / 4
    return max(1.0, float(spec.bytes_per_sec(symbol_rate)))


def calculate_transmission_stats(
    file_size: int, mode: str, symbol_rate: int, compress: bool = True
) -> dict:
    """Estimated on-air duration/bitrate using the design efficiency map."""
    bps = _bytes_per_sec(mode, symbol_rate)
    compression_ratio = 0.4 if compress and mode not in ("SSTV", "HELLSCHREIBER") else 1.0
    effective = file_size * compression_ratio
    duration = effective / bps if bps > 0 else float("inf")
    return {
        "original_size": file_size,
        "effective_size": int(effective),
        "compression_ratio": compression_ratio,
        "bytes_per_sec": bps,
        "duration_sec": duration,
        "duration_min": duration / 60,
        "bitrate_bps": bps * 8,
    }


def get_encoding_stats(file_path: str, mode: str, compress: bool, symbol_rate: int) -> dict:
    return calculate_transmission_stats(os.path.getsize(file_path), mode, symbol_rate, compress)


# --- audio verification -------------------------------------------------------

def verify_audio_output(audio_array: Optional[np.ndarray], expected_min_duration: float = 0.1) -> bool:
    """8-point waveform validity checklist (reference encoder.py:318-349)."""
    if audio_array is None or len(audio_array) == 0:
        return False
    arr = np.asarray(audio_array)
    checks = (
        not np.all(arr == 0),
        len(arr) / SAMPLE_RATE >= expected_min_duration,
        float(np.std(arr)) >= 0.01,
        not np.any(np.isnan(arr)),
        not np.any(np.isinf(arr)),
        bool(np.all(np.abs(arr) <= 1.0)),
    )
    return all(checks)


# --- multi-part splitting -----------------------------------------------------

def split_file_for_transmission(
    file_path: str, mode: str, symbol_rate: int, target_duration_sec: int = 60
) -> List[FilePart]:
    """Split a file into parts sized for ~``target_duration_sec`` on air.

    Part payload budget is 90% of the mode's design throughput x duration
    (reference encoder.py:117-151); parts are named ``<name>.partN``.
    """
    file_size = os.path.getsize(file_path)
    fname = os.path.basename(file_path)
    with open(file_path, "rb") as f:
        file_data = f.read()
    file_crc = crc32(file_data)

    part_size = max(1, int(_bytes_per_sec(mode, symbol_rate) * target_duration_sec * 0.9))
    if file_size <= part_size:
        return [(fname, file_data, 0, 1, file_size, file_crc)]

    total = math.ceil(file_size / part_size)
    return [
        (
            f"{fname}.part{i + 1}",
            file_data[i * part_size : (i + 1) * part_size],
            i,
            total,
            file_size,
            file_crc,
        )
        for i in range(total)
    ]


# --- encoding -----------------------------------------------------------------

def _modulate_with_fallback(
    mode: str, framed: bytes, symbol_rate: int, min_duration: float = 0.0
) -> np.ndarray:
    """Modulate; on invalid audio fall back to BPSK<=4800, then a test tone.

    The three-stage ladder is the reference's fault-tolerance story
    (encoder.py:206-226). ``min_duration`` is 0 on the single-file path —
    legitimately short payloads produce legitimately short audio (the
    reference's 0.1 s floor there would misfire; it only verifies on the
    multi-part path anyway, encoder.py:284-296).
    """
    if mode not in MODES:
        # Reference parity: its encode dispatch sends unknown mode names to
        # QPSK (encoder.py:284-296 default arm) rather than erroring.
        logger.warning("unknown mode %s; encoding as QPSK like the reference", mode)
        mode = "QPSK"
    try:
        arr = modulate(mode, framed, symbol_rate)
    except Exception as exc:  # modulator bug / bad artifact: the BPSK ladder
        logger.error("mode %s failed to modulate (%s); falling back to BPSK", mode, exc)
        arr = np.zeros(0, np.float32)
    if verify_audio_output(arr, min_duration):
        return arr
    logger.error("mode %s produced invalid audio; falling back to BPSK", mode)
    fallback_rate = min(symbol_rate, 4800)
    arr = bpsk_modulate(framed, baud=fallback_rate, carrier=3000.0)
    if verify_audio_output(arr):
        return arr
    logger.error("BPSK fallback also failed; emitting test tone")
    duration = max(len(framed) / fallback_rate, 1.0)
    t = np.linspace(0, duration, int(SAMPLE_RATE * duration))
    arr = (0.8 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    if not verify_audio_output(arr):
        raise ValueError("could not produce valid modulated audio")
    return arr


def encode_file_parts(
    file_parts: List[FilePart],
    mode: str,
    compress: bool,
    symbol_rate: int,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    is_cancelled: Optional[Callable[[], bool]] = None,
    cache_dir: str = CACHE_DIR,
    use_fec: Optional[bool] = None,
    fec_type: Optional[str] = None,
) -> List[str]:
    """Encode each part to ``cache/<name>.<MODE>.sr<rate>.wav``.

    ``use_fec`` wraps each compressed payload in a tagged FEC container
    (type from CONFIG ``modem.fec_type`` unless given) so bit errors on the
    air can be corrected on receive; ``None`` defers to CONFIG
    ``modem.fec_enabled`` (default False — the reference declares
    ``fec_enabled: True`` but never implemented it, and enabling changes the
    wire bytes, breaking interop with reference decoders; see COMPAT.md).
    """
    out_dir = _ensure_cache_dir(cache_dir)
    encoded: List[str] = []
    n = len(file_parts)

    for idx, (fname, data, part_number, total_parts, file_size, file_crc) in enumerate(file_parts):
        if _cancelled(is_cancelled):
            raise RuntimeError("encoding cancelled")

        payload = adaptive_compress(data, mode) if compress else data
        if use_fec is None:
            use_fec = bool(CONFIG.get("modem.fec_enabled", False))
        ftype = fec_type or CONFIG.get("modem.fec_type", "reed_solomon")
        if use_fec and ftype != "stream":
            payload = wrap_fec(payload, ftype)
        framed = pack_frame(fname, payload, part_number, total_parts, file_size, file_crc)
        if use_fec and ftype == "stream":
            # Stream FEC codes the WHOLE frame (header+magic+CRCs included) —
            # receivers must decode with stream_fec=True; see fec.py.
            framed = stream_fec_encode(framed)
        arr = _modulate_with_fallback(mode, framed, symbol_rate, min_duration=0.1)

        wav_bytes = wav_from_array(arr, SAMPLE_RATE)
        outname = os.path.join(out_dir, f"{fname}.{mode}.sr{symbol_rate}.wav")
        with open(outname, "wb") as f:
            f.write(wav_bytes)
        if not (os.path.exists(outname) and os.path.getsize(outname) > 100):
            raise IOError(f"failed to save encoded WAV: {outname}")
        encoded.append(outname)
        logger.info("encoded part %d/%d -> %s (%d bytes)", idx + 1, n, outname, len(wav_bytes))
        if progress_callback:
            progress_callback(idx + 1, n)

    return encoded


def encode_hellschreiber_text(
    text: str, cache_dir: str = CACHE_DIR, baud: float = 122.5, carrier: float = 1000.0
) -> str:
    """Encode plain text as a Hellschreiber WAV (the reference stubs this,
    encoder.py:255-257; here it actually modulates)."""
    from .ops.hell import hellschreiber_modulate

    out_dir = _ensure_cache_dir(cache_dir)
    arr = hellschreiber_modulate(text, baud, carrier)
    # crc32, not hash(): PYTHONHASHSEED makes hash() differ across processes,
    # which made re-encoding the same text produce a new file every run.
    outname = os.path.join(
        out_dir, f"hellschreiber_{crc32(text.encode('utf-8')) & 0xFFFFFF:06x}.wav"
    )
    with open(outname, "wb") as f:
        f.write(wav_from_array(arr, SAMPLE_RATE))
    return outname


def encode_file(
    path: str,
    mode: str = "QPSK",
    compress: bool = True,
    symbol_rate: int = 9600,
    split_large_files: bool = True,
    target_duration_min: int = 1,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    is_cancelled: Optional[Callable[[], bool]] = None,
    cache_dir: str = CACHE_DIR,
    use_fec: Optional[bool] = None,
    fec_type: Optional[str] = None,
) -> str:
    """Encode one file to a WAV; multi-parts automatically when it would
    exceed the target on-air duration. Returns the first WAV path (single
    part) — use :func:`encode_file_paths` for the full list."""
    paths = encode_file_paths(
        path,
        mode,
        compress,
        symbol_rate,
        split_large_files,
        target_duration_min,
        progress_callback,
        is_cancelled,
        cache_dir,
        use_fec,
        fec_type,
    )
    return paths[0] if paths else ""


def encode_file_paths(
    path: str,
    mode: str = "QPSK",
    compress: bool = True,
    symbol_rate: int = 9600,
    split_large_files: bool = True,
    target_duration_min: int = 1,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    is_cancelled: Optional[Callable[[], bool]] = None,
    cache_dir: str = CACHE_DIR,
    use_fec: Optional[bool] = None,
    fec_type: Optional[str] = None,
) -> List[str]:
    """Encode one file to one or more WAVs (the multi-part-aware API)."""
    reset_encoding_cancel()
    fname = os.path.basename(path)
    out_dir = _ensure_cache_dir(cache_dir)

    if split_large_files:
        parts = split_file_for_transmission(path, mode, symbol_rate, target_duration_min * 60)
        if len(parts) > 1:
            return encode_file_parts(
                parts, mode, compress, symbol_rate, progress_callback, is_cancelled,
                cache_dir, use_fec, fec_type,
            )

    with open(path, "rb") as f:
        raw = f.read()
    file_crc = crc32(raw)
    data = intelligent_compress(raw) if compress else raw
    if use_fec is None:
        use_fec = bool(CONFIG.get("modem.fec_enabled", False))
    ftype = fec_type or CONFIG.get("modem.fec_type", "reed_solomon")
    if use_fec and ftype != "stream":
        data = wrap_fec(data, ftype)
    framed = pack_frame(fname, data, 0, 1, len(raw), file_crc)
    if use_fec and ftype == "stream":
        framed = stream_fec_encode(framed)
    arr = _modulate_with_fallback(mode, framed, symbol_rate)
    wav_bytes = wav_from_array(arr, SAMPLE_RATE)
    outname = os.path.join(out_dir, f"{fname}.{mode}.wav")
    with open(outname, "wb") as f:
        f.write(wav_bytes)
    if progress_callback:
        progress_callback(1, 1)
    return [outname]
