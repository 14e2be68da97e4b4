"""Profiler trace of the batched WAV decode on the GPU, reduced to numbers.

Two traced windows over the farm cell (16 five-minute QPSK@9600 captures,
built by ``chip_smoke.make_captures``), each after a warm-up call:

1. ``decode_wav_batch`` from disk — the served path. Reports the window's
   wall time, the device's busy time (union of the kernel and copy
   intervals on the GPU's stream lines) and its idle share.
2. ``demod_pack_batch`` alone on device-resident host-shaped rows (3 calls)
   — the device program. Reports device time per kernel (the events on
   the stream lines, by name, with their ``hlo_op`` stat), largest first,
   and XLA's own cost analysis of the program (flops, bytes accessed).

Prints the device line first and one JSON object last; ``--out`` also
writes the JSON. Usage::

    python benchmarks/trace_decode.py [--captures 16] [--minutes 5] [--out FILE]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Tuple


HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def _union_ns(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(trace_dir: str, top: int = 15) -> Dict[str, object]:
    """Device busy time, and device time per kernel, from the newest trace
    in ``trace_dir``. GPU planes carry one line per CUDA stream; every
    kernel and copy on them counts toward busy time."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = ProfileData.from_file(path)
    busy: List[Tuple[float, float]] = []
    ops: Dict[str, List[float]] = {}
    lines_seen = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen[f"{plane.name}|{line.name}"] = len(events)
            if not line.name.startswith("Stream"):
                continue
            for e in events:
                busy.append((e.start_ns, e.end_ns))
                stats = dict(e.stats)
                slot = ops.setdefault(e.name, [0.0, 0, str(stats.get("hlo_op", ""))])
                slot[0] += e.duration_ns
                slot[1] += 1
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "lines": lines_seen,
        "device_busy_ms": _union_ns(busy) / 1e6,
        "kernel_total_ms": sum(v[0] for v in ops.values()) / 1e6,
        "top_kernels": [
            {"kernel": k, "ms": v[0] / 1e6, "count": v[1], "hlo_op": v[2]}
            for k, v in ranked[:top]
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", type=int, default=16)
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax

    import chip_smoke
    from _timing import device_header
    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch
    from audio_modem_radio.utils.runtime import configure_compile_cache

    configure_compile_cache()
    header = device_header()
    n_samples = int(args.minutes * 60 * chip_smoke.SR)
    result: Dict[str, object] = {**header, "captures": args.captures, "minutes": args.minutes}
    with tempfile.TemporaryDirectory(prefix="trace_decode_") as work:
        paths, payloads = chip_smoke.make_captures(
            work, "tr", "QPSK", chip_smoke.RATE, args.captures, n_samples, fill=0.9, seed=1
        )
        chip_smoke.decode_and_check(paths, payloads, "QPSK", chip_smoke.RATE, os.path.join(work, "r0"))
        tdir = os.path.join(work, "trace_e2e")
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            chip_smoke.decode_and_check(
                paths, payloads, "QPSK", chip_smoke.RATE, os.path.join(work, "r1")
            )
        wall = time.perf_counter() - t0
        e2e = reduce_trace(tdir)
        e2e["wall_ms"] = wall * 1e3
        e2e["device_idle_share"] = 1.0 - e2e["device_busy_ms"] / e2e["wall_ms"]
        result["decode_wav_batch"] = e2e

        batch = chip_smoke.load_batch(paths)
        x = jax.device_put(host_shape_batch(batch, "QPSK", chip_smoke.RATE))
        jax.block_until_ready(demod_pack_batch(x, "QPSK", chip_smoke.RATE))
        tdir = os.path.join(work, "trace_demod")
        with jax.profiler.trace(tdir):
            for _ in range(3):
                jax.block_until_ready(demod_pack_batch(x, "QPSK", chip_smoke.RATE))
        dev = reduce_trace(tdir)
        dev["calls"] = 3
        dev["shape"] = list(batch.shape)
        cost = demod_pack_batch.lower(x, "QPSK", chip_smoke.RATE).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        dev["xla_cost"] = {
            k: float(v) for k, v in (cost or {}).items()
            if k in ("flops", "bytes accessed", "transcendentals")
        }
        result["demod_pack_batch"] = dev
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
