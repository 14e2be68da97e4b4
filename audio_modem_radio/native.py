"""ctypes bindings for the native (C++) runtime library.

``native/amr_native.cpp`` provides the host-runtime hot paths for batch
decoding: a zlib-backed FBPC frame scanner and a multi-threaded WAV batch
loader. The library is compiled on demand with g++ (cached next to the
source); every entry point has a pure-Python fallback, so the package works
identically — just slower at scale — when no compiler is available.

API:
  * :func:`scan_frames` — native-or-fallback equivalent of
    ``framing.parse_frames_detailed``.
  * :func:`load_wav_batch` — N WAV files -> (B, row_len) float32 matrix +
    per-file sample rates, parallel across files.
  * :data:`NATIVE_AVAILABLE` — whether the shared library loaded.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("audio_modem_radio")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "amr_native.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libamr_native.so")

_lib = None
_lib_lock = threading.Lock()


class _FrameDesc(ctypes.Structure):
    _fields_ = [
        ("name_off", ctypes.c_uint64),
        ("name_len", ctypes.c_uint32),
        ("payload_off", ctypes.c_uint64),
        ("payload_len", ctypes.c_uint32),
        ("part_number", ctypes.c_uint32),
        ("total_parts", ctypes.c_uint32),
        ("file_size", ctypes.c_uint32),
        ("file_crc", ctypes.c_uint32),
        ("crc_ok", ctypes.c_uint32),
    ]


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
    tail = [_SRC, "-o", _LIB, "-lz"]
    # -march=native roughly doubles the Viterbi ACS sweep (vectorized metric
    # adds); fall back to the portable build where the flag is unsupported.
    for flags in (base + ["-march=native"] + tail, base + tail):
        try:
            subprocess.run(flags, check=True, capture_output=True, timeout=120)
            return True
        except FileNotFoundError as e:
            logger.info("native build unavailable (%s); using Python fallbacks", e)
            return False
        except subprocess.SubprocessError:
            continue
    logger.info("native build failed; using Python fallbacks")
    return False


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            # Source newer than the library and no rebuild possible -> use
            # the always-correct Python fallbacks rather than risk a stale
            # ABI (a single-symbol hasattr check below can't catch struct
            # layout changes). Toolchain-less hosts never hit this: the
            # standalone bundle ships its .so with a fresh mtime
            # (tools/build_standalone.py).
            if not _build():
                _lib = False
                return False
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _lib = False
            return False
        if not hasattr(lib, "amr_crc32_prefix_find"):
            # Stale library built from an older source (e.g. shipped without
            # amr_native.cpp, so the mtime rebuild check never fired): try
            # one rebuild; if the source is absent, fall back to Python
            # rather than raising at attribute setup.
            if not (_build() and hasattr(lib := ctypes.CDLL(_LIB), "amr_crc32_prefix_find")):
                logger.info("native library is stale and cannot rebuild; using Python fallbacks")
                _lib = False
                return False
        lib.amr_scan_frames.restype = ctypes.c_int64
        lib.amr_scan_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(_FrameDesc),
            ctypes.c_int64,
        ]
        lib.amr_crc32_prefix_find.restype = ctypes.c_int64
        lib.amr_crc32_prefix_find.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]
        lib.amr_load_wav_batch.restype = None
        lib.amr_load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        if hasattr(lib, "amr_viterbi_decode"):
            lib.amr_viterbi_decode.restype = ctypes.c_int64
            lib.amr_viterbi_decode.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
        _lib = lib
        return lib


def available() -> bool:
    return bool(_load())


def scan_frames(raw: bytes, max_frames: int = 4096):
    """Native FBPC scan -> (valid_frames, damaged_frames); falls back to
    the Python parser when the library is unavailable."""
    from .framing import Frame, parse_frames_detailed

    lib = _load()
    if not lib:
        return parse_frames_detailed(raw)
    out = (_FrameDesc * max_frames)()
    n = lib.amr_scan_frames(raw, len(raw), out, max_frames)
    valid: List[Frame] = []
    damaged: List[Frame] = []
    for i in range(n):
        d = out[i]
        name = raw[d.name_off : d.name_off + d.name_len].decode("utf-8", "ignore")
        payload = raw[d.payload_off : d.payload_off + d.payload_len]
        frame = Frame(name, payload, d.part_number, d.total_parts, d.file_size, d.file_crc)
        (valid if d.crc_ok else damaged).append(frame)
    return valid, damaged


def crc32_prefix_find(buf: bytes, target: int) -> Optional[int]:
    """Length of the shortest prefix of ``buf`` whose CRC32 equals
    ``target`` (0 = none), or None when the native library is unavailable
    (caller falls back to the Python scan). ~100x the Python per-byte loop."""
    lib = _load()
    if not lib:
        return None
    return int(lib.amr_crc32_prefix_find(buf, len(buf), target & 0xFFFFFFFF))


def viterbi_available() -> bool:
    """Whether the native ACS decoder is loadable (gates the header-recovery
    span cap in decoder.py: multi-MB Viterbi validation is only affordable
    through the C++ sweep — the 64-state trellis scan is sequential, a poor
    fit for an accelerator)."""
    lib = _load()
    return bool(lib) and hasattr(lib, "amr_viterbi_decode")


def viterbi_decode_pairs(pairs: np.ndarray, known_boundaries: bool = True) -> Optional[np.ndarray]:
    """Native K=7 rate-1/2 Viterbi: (T, 2) hard/soft pairs -> (T,) bits.

    One exact full-length ACS sweep (no block approximation) with semantics
    identical to ``fec._viterbi_block``: L1 branch metric, ties keep the
    ``s >> 1`` predecessor, traceback from state 0 when ``known_boundaries``
    else from the best end state. Returns None when the library is
    unavailable (caller falls back to the JAX trellis scan).
    """
    lib = _load()
    if not lib or not hasattr(lib, "amr_viterbi_decode"):
        return None
    p = np.ascontiguousarray(pairs, dtype=np.float32)
    T = int(p.shape[0])
    out = np.empty(T, dtype=np.uint8)
    rc = lib.amr_viterbi_decode(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        1 if known_boundaries else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def load_wav_batch(
    paths: Sequence[str], row_len: int, max_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load WAVs into a zero-padded (B, row_len) float32 matrix, in parallel.

    Returns ``(samples, rates, n_samples)``; ``rates[i] == 0`` marks a file
    that failed to parse. Python fallback reads sequentially via utils.wavio.
    """
    lib = _load()
    b = len(paths)
    out = np.zeros((b, row_len), dtype=np.float32)
    rates = np.zeros(b, dtype=np.int32)
    counts = np.zeros(b, dtype=np.int64)
    if not lib:
        from .utils.wavio import read_wav

        for i, p in enumerate(paths):
            try:
                data, sr = read_wav(p)
            except Exception:
                continue
            n = min(len(data), row_len)
            out[i, :n] = data[:n]
            rates[i] = sr
            counts[i] = n
        return out, rates, counts

    c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    lib.amr_load_wav_batch(
        c_paths,
        b,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        row_len,
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_threads,
    )
    return out, rates, counts


NATIVE_AVAILABLE = available()
