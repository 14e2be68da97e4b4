"""Logging, log rotation, performance monitoring, and analytics.

Capability parity with the reference's observability surface:

* :func:`setup_logging` — dual file+console handlers on one named logger
  (reference filebeep_advanced_v2.py:41-71).
* :class:`LogManager` — size-capped log rotation (10 MB default, reference
  :1435-1461).
* :class:`PerformanceMonitor` — psutil CPU/RAM/disk poller
  (reference :378-398), plus JAX device enumeration.
* :class:`AnalyticsStore` — persists the analytics schema the reference
  *declares* but never writes (files_sent/received, bytes, error counts,
  modes_used, performance_metrics — /root/reference/filebeep_analytics.json);
  here encode/decode events actually update it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

try:
    import psutil

    PSUTIL_AVAILABLE = True
except ImportError:  # pragma: no cover
    PSUTIL_AVAILABLE = False

LOGGER_NAME = "audio_modem_radio"


def setup_logging(
    log_file: str = "audio_modem_system.log",
    level: int = logging.INFO,
    console: bool = True,
    to_file: bool = True,
) -> logging.Logger:
    """Configure the package logger with optional file + console handlers.

    ``to_file=False`` skips the file handler — the apps pass CONFIG
    ``ui.auto_save_logs`` here (the reference declares the key unread).
    """
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if to_file:
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    logger.info("logging initialized -> %s", log_file if to_file else "(console only)")
    return logger


class LogManager:
    """Rotates a log file when it exceeds ``max_bytes`` (default 10 MB)."""

    def __init__(self, log_file: str = "audio_modem_system.log", max_bytes: int = 10 * 1024 * 1024):
        self.log_file = log_file
        self.max_bytes = max_bytes

    def should_rotate(self) -> bool:
        return os.path.exists(self.log_file) and os.path.getsize(self.log_file) > self.max_bytes

    def rotate(self) -> Optional[str]:
        if not self.should_rotate():
            return None
        rotated = f"{self.log_file}.{int(time.time())}"
        os.replace(self.log_file, rotated)
        return rotated


class PerformanceMonitor:
    """Polls host CPU/RAM/disk and JAX device info."""

    def __init__(self, interval_s: float = 2.0):
        self.interval_s = interval_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.latest: Dict[str, Any] = {}

    def sample(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"timestamp": time.time()}
        if PSUTIL_AVAILABLE:
            info["cpu_percent"] = psutil.cpu_percent(interval=None)
            info["ram_percent"] = psutil.virtual_memory().percent
            try:
                info["disk_percent"] = psutil.disk_usage(os.getcwd()).percent
            except OSError:
                pass
        try:
            import jax

            info["devices"] = [str(d) for d in jax.devices()]
        except Exception:
            pass
        self.latest = info
        return info

    def start(self, callback=None) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                info = self.sample()
                if callback:
                    callback(info)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval_s * 2)
            self._thread = None


class AnalyticsStore:
    """Thread-safe usage analytics with JSON persistence.

    Implements the schema shipped (but never populated) by the reference's
    ``filebeep_analytics.json``.
    """

    def __init__(self, path: str = "audio_modem_analytics.json"):
        self.path = path
        self._lock = threading.Lock()
        self.data: Dict[str, Any] = {
            "files_sent": 0,
            "files_received": 0,
            "bytes_sent": 0,
            "bytes_received": 0,
            "encode_errors": 0,
            "decode_errors": 0,
            "modes_used": {},
            "performance_metrics": {},
            "session_start": time.time(),
        }
        self.load()

    def load(self) -> None:
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    stored = json.load(f)
                with self._lock:
                    for k, v in stored.items():
                        if k in self.data and k != "session_start":
                            self.data[k] = v
            except (json.JSONDecodeError, OSError):
                pass

    def save(self) -> None:
        with self._lock:
            snapshot = dict(self.data)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot, f, indent=2)
        os.replace(tmp, self.path)

    def record_encode(self, mode: str, n_bytes: int, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.data["files_sent"] += 1
                self.data["bytes_sent"] += n_bytes
            else:
                self.data["encode_errors"] += 1
            self.data["modes_used"][mode] = self.data["modes_used"].get(mode, 0) + 1

    def record_decode(self, mode: str, n_bytes: int, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.data["files_received"] += 1
                self.data["bytes_received"] += n_bytes
            else:
                self.data["decode_errors"] += 1
            self.data["modes_used"][mode] = self.data["modes_used"].get(mode, 0) + 1

    def record_metric(self, name: str, value: float) -> None:
        with self._lock:
            self.data["performance_metrics"][name] = value


analytics = AnalyticsStore()
