"""Configuration system: nested dict with dotted-key access and JSON persistence.

Capability parity with the reference config manager (/root/reference/config.py:6-88):
singleton with nested defaults, ``get``/``set`` on dotted keys, ``save_to_file`` /
``load_from_file`` JSON round-trip, and the quality-threshold helpers. The defaults
mirror the reference's shipped values (config.py:18-51) so behavior-sensitive
consumers (compression flags, sample rate, assembly thresholds) see the same policy.

Deviation from the reference (documented in COMPAT.md): the reference's ``get``
returns the default only when the key walk ends in ``{}`` (config.py:53-58), which
makes an intermediate *present* empty dict indistinguishable from a missing key and
crashes when walking through a non-dict leaf. We implement the intended behavior —
missing key => default, present value (including falsy) => value.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from typing import Any, Dict

# Every key below is READ by some code path (the reference declares several
# flags nothing reads, /root/reference/config.py:24-44; here dead keys were
# either wired to the intended behavior or dropped — the deletions and the
# default flips are recorded in COMPAT.md "config flags").
_DEFAULTS: Dict[str, Any] = {
    "modem": {
        # Default for encode-side FEC wrapping (encoder.encode_file*). The
        # reference ships ``fec_enabled: True`` but its FEC is dead code; we
        # default False because enabling changes the wire bytes (FECP/FECV
        # container) and would break interop with reference decoders — the
        # reference's EFFECTIVE behavior is "off". Set True to honor it.
        "fec_enabled": False,
        "fec_type": "reed_solomon",  # 'reed_solomon' | 'convolutional' | 'stream'
        # CFO robustness in the batched PSK decode (derotation + quarter-turn
        # sync retry); ~15% throughput cost. Disable for carrier-exact farms.
        "cfo_retry": True,
        # MLSE refinement in the BATCHED FSK decode (the single-file path
        # always runs it): ~3x throughput cost for a ~1.5e-5 -> 0 BER gain.
        "batch_mlse": False,
        "sample_rate": 96000,
        "quality_threshold": 0.4,
        # Quality margin a duplicate part must exceed to replace a received
        # one (assembly.FileAssembly.add_part). The reference declares the key
        # but replaces on ANY improvement; honoring 0.15 would REJECT healing
        # retransmissions barely better than a bad part, so the wired default
        # is 0.0 (= the reference's effective behavior).
        "duplicate_replacement_threshold": 0.0,
        # Expiry for in-flight multi-part assemblies, seconds (the default
        # AssemblyRegistry reads this at construction).
        "assembly_timeout": 7200,
        # Disk journal for restart-safe multi-part transfers: every accepted
        # part is written atomically under this directory and replayed on the
        # next start, so a reception spanning assembly_timeout survives a
        # process restart (the reference's FileAssembly is memory-only,
        # SURVEY.md §5). Empty string disables journaling.
        "assembly_journal": "recv/.assembly",
        # Coherent escalation for the PSK-family receives (BPSK/QPSK/8PSK):
        # when differential detection yields no CRC-valid frame, retry with
        # the Viterbi&Viterbi carrier tracker (absolute-sector decisions,
        # measured ON the coherent bound — +2.3 dB at 8PSK/DQPSK, ~1 dB at
        # DBPSK; PERF.md "Coherent-tracked PSK escalation"). Costs one
        # extra front-end pass ONLY on captures the fast path failed.
        "psk_coherent_escalation": True,
        # Default for the decode-side spectral-gate denoiser (decoder.decode_*
        # ``denoise=None`` resolves here). The reference declares
        # ``noise_reduction: True`` but implements nothing; the receivers are
        # matched-filter-optimal under AWGN, so the real denoiser defaults
        # off and is opted in for structured interference.
        "noise_reduction": False,
    },
    "compression": {
        "enabled": True,
        "lzma_enabled": True,
        "delta_compression": True,
    },
    "performance": {
        # Threads for the native batch WAV loader (parallel.batch
        # decode_wav_batch); 0 = one per hardware core.
        "max_workers": 4,
    },
    "ui": {
        # ConsoleApp/TUI: write the session log file (observability.setup_logging).
        "auto_save_logs": True,
        # TUI stats/assembly pane refresh period, milliseconds.
        "refresh_interval": 2000,
    },
    # Batched device decode knobs (no reference analog).
    "device": {
        # Capture lengths are zero-padded up to the next of these sizes so
        # one compiled program serves many lengths (decoder.pad_to_bucket).
        "batch_bucket_sizes": [1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 25],
        # PSK/HELL batch rows ship to the device as int16 (production WAVs
        # are int16 PCM and the receive pipeline is scale-invariant): halves
        # the host-to-device transfer. Exact for int16-sourced audio;
        # resampled/denoised floats requantize at -90 dB, far below any
        # channel noise.
        "int16_rows": False,
        # Opt-in int8 rows: quarters the transfer. ~-50 dB quantization
        # noise (harmless at any operating SNR) but not bit-exact to
        # int16-PCM sources — enable deliberately.
        "int8_rows": False,
    },
    "intelligence": {
        # False (default): the mode recommender scores measured-waterfall
        # profiles over every real mode family (intelligence.MODE_PROFILES,
        # floors from benchmarks/ber_results_r5.json). True: the reference's
        # exact 5-mode static table for behavior parity
        # (/root/reference/intelligent_communication.py:37-42).
        "compat_profiles": False,
    },
}

_MISSING = object()


class ConfigManager:
    """Thread-safe singleton configuration store with dotted-key access."""

    _instance = None
    _lock = threading.Lock()

    def __new__(cls):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    inst = super().__new__(cls)
                    inst._config = copy.deepcopy(_DEFAULTS)
                    cls._instance = inst
        return cls._instance

    def get(self, key: str, default: Any = None) -> Any:
        node: Any = self._config
        for part in key.split("."):
            if isinstance(node, dict):
                node = node.get(part, _MISSING)
            else:
                node = _MISSING
            if node is _MISSING:
                return default
        return node

    def set(self, key: str, value: Any) -> None:
        parts = key.split(".")
        node = self._config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def save_to_file(self, filename: str = "filebeep_config.json") -> None:
        with open(filename, "w") as f:
            json.dump(self._config, f, indent=2)

    def load_from_file(self, filename: str = "filebeep_config.json") -> None:
        if os.path.exists(filename):
            with open(filename) as f:
                self._config.update(json.load(f))

    def reset(self) -> None:
        """Restore shipped defaults (mainly for tests)."""
        self._config = copy.deepcopy(_DEFAULTS)


CONFIG = ConfigManager()


def get_quality_threshold() -> float:
    return CONFIG.get("modem.quality_threshold", 0.3)


def set_quality_threshold(value: float) -> None:
    CONFIG.set("modem.quality_threshold", max(0.0, min(1.0, value)))
