"""Streaming decode: incremental demodulation of a live capture.

The reference records a fixed 30 s window and decodes it in one shot
(WorkerRecord, filebeep_advanced_v2.py:282-331); frames that arrive during a
long session only surface at the end. This decoder processes the capture in
overlapping windows as audio arrives, so files appear as soon as their frames
complete — the SURVEY §5 "long audio stream" mapping: blockwise windows
through the same jitted demod programs, with enough overlap that a frame
spanning a window boundary is fully contained in the next window.

De-duplication: the same frame decoded from two overlapping windows is
keyed by (name, part, payload CRC) and saved once.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Set, Tuple

import numpy as np

from .assembly import AssemblyRegistry
from .decoder import RECV_DIR, save_decoded_files
from .framing import crc32, parse_frames_detailed
from .modem import SAMPLE_RATE, demodulate
from .utils.wavio import resample

logger = logging.getLogger("audio_modem_radio")


class StreamingDecoder:
    """Feed sample chunks; recovered files are saved as frames complete.

    Window length is a fixed bucket (one jit program, reused every step);
    consecutive windows overlap by ``overlap`` samples. Frames longer than
    ``window - overlap`` may never fit a single window — size the window for
    the longest expected transmission (default 2^22 samples ≈ 43.7 s at
    96 kHz against the reference's 60 s part-duration default at its design
    rates, whose frames are far shorter than this in samples).
    """

    def __init__(
        self,
        mode: str,
        symbol_rate: int,
        window: int = 1 << 22,
        overlap: Optional[int] = None,
        sample_rate: int = SAMPLE_RATE,
        recv_dir: str = RECV_DIR,
        registry: Optional[AssemblyRegistry] = None,
    ):
        self.mode = mode
        self.symbol_rate = symbol_rate
        self.window = window
        self.overlap = overlap if overlap is not None else window // 2
        if not 0 <= self.overlap < window:
            raise ValueError("overlap must be in [0, window)")
        self.sample_rate = sample_rate
        self.recv_dir = recv_dir
        self.registry = registry or AssemblyRegistry()
        self._buf = np.zeros(0, dtype=np.float32)
        self._seen: Set[Tuple[str, int, int]] = set()
        self.saved_files: List[str] = []

    @property
    def pending(self) -> int:
        """Samples buffered but not yet decoded (under one window)."""
        return len(self._buf)

    def feed(self, samples: np.ndarray) -> List[str]:
        """Append captured samples; returns newly saved file paths."""
        chunk = np.asarray(samples, dtype=np.float32)
        if chunk.ndim > 1:
            chunk = chunk[:, 0]
        if self.sample_rate != SAMPLE_RATE:
            chunk = resample(chunk, self.sample_rate, SAMPLE_RATE)
        self._buf = np.concatenate([self._buf, chunk])
        saved: List[str] = []
        while len(self._buf) >= self.window:
            saved += self._decode_window(self._buf[: self.window])
            self._buf = self._buf[self.window - self.overlap :]
        return saved

    def flush(self) -> List[str]:
        """Decode whatever remains in the buffer (end of capture)."""
        saved: List[str] = []
        # feed() keeps the buffer under one window, but guard anyway so a
        # direct flush after a huge final chunk can never discard samples.
        while len(self._buf) >= self.window:
            saved += self._decode_window(self._buf[: self.window])
            self._buf = self._buf[self.window - self.overlap :]
        if len(self._buf) == 0:
            return saved
        tail = np.zeros(self.window, dtype=np.float32)
        tail[: len(self._buf)] = self._buf
        self._buf = np.zeros(0, dtype=np.float32)
        return saved + self._decode_window(tail)

    def _decode_window(self, window_samples: np.ndarray) -> List[str]:
        raw = demodulate(self.mode, window_samples, self.symbol_rate)
        frames, damaged = parse_frames_detailed(raw)
        # Header-tolerant pass (decoder.recover_header_damaged): rescues
        # frames whose header bits took errors. Cheap when nothing matches
        # (one vectorized scan); validated recoveries join the normal dedup
        # and supersede damaged-path guesses for the same (name, part).
        from .decoder import recover_header_damaged

        recovered = recover_header_damaged(
            raw, list(frames),
            stats=(self.registry.stats if self.registry is not None else None),
        )
        rec_keys = {(f.name, f.part_number) for f in recovered}
        damaged = [d for d in damaged if (d.name, d.part_number) not in rec_keys]
        frames = list(frames) + recovered
        fresh = []
        for f in frames:
            key = (f.name, f.part_number, crc32(f.data))
            if key in self._seen:
                continue
            self._seen.add(key)
            fresh.append(f)
        if not fresh and not damaged:
            return []
        saved = save_decoded_files(fresh, self.recv_dir, self.registry, damaged=damaged or None)
        self.saved_files += saved
        return saved
