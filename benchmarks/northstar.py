"""North-star workload: decode 1000 five-minute 96 kHz captures on one GPU.

BASELINE.json's corpus shape: 1000 captures of 28.8 M samples each (28.8
Gsamples in all) through the fused batched receive, ``--batch`` distinct
transmissions per dispatch, every dispatch synced with
``jax.block_until_ready``; the last round's decodes are checked against
their payloads. A device-resident layer metric: the batch is put on the
device once and re-decoded each round (the served path from WAV files on
disk is ``decode_wav_batch``, exercised by chip_smoke.py).

Usage: python benchmarks/northstar.py [--captures 1000] [--batch 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--captures", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--minutes", type=float, default=5.0)
    args = ap.parse_args()

    import jax

    from _timing import device_header
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio.modem import modulate
    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch
    from audio_modem_radio.utils.runtime import configure_compile_cache

    configure_compile_cache()
    header = device_header()
    sr, baud = 96000, 9600
    n_samples = int(args.minutes * 60 * sr)  # 28.8 M for 5 min
    b = args.batch

    # One batch of distinct transmissions, each repeated to fill its
    # capture, reused every round (identical compute per round; contents
    # verified on the last round's results).
    rng = np.random.default_rng(0)
    print(f"synthesizing {b} distinct {args.minutes:.0f}-min captures...", flush=True)
    payloads = []
    flat = np.zeros((b, n_samples), np.float32)
    for i in range(b):
        payload = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
        framed = pack_frame(f"ns{i}.bin", payload, 0, 1, len(payload), crc32(payload))
        wave = np.asarray(modulate("QPSK", framed, baud), np.float32)
        reps = -(-n_samples // len(wave))
        flat[i] = np.tile(wave, reps)[:n_samples]
        payloads.append(payload)
    x = jax.device_put(host_shape_batch(flat, "QPSK", baud))
    del flat

    out = jax.block_until_ready(demod_pack_batch(x, "QPSK", baud))  # compile + warm

    rounds = -(-args.captures // b)
    print(f"decoding {rounds * b} captures in {rounds} rounds of {b}...", flush=True)
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = jax.block_until_ready(demod_pack_batch(x, "QPSK", baud))
    wall = time.perf_counter() - t0

    # Verify the final round's decodes.
    packed, n_valid, found = out
    ok = 0
    for i in range(b):
        raw = np.asarray(packed[i])[: int(n_valid[i])].tobytes()
        frames = parse_frames(raw)
        ok += bool(frames and frames[0].data == payloads[i])

    total_captures = rounds * b
    total_samples = total_captures * n_samples
    audio_seconds = total_captures * args.minutes * 60
    result = {
        "metric": "northstar_realtime_factor",
        "captures": total_captures,
        "minutes_each": args.minutes,
        "device": header["device"],
        "card": header["card"],
        "wall_seconds": wall,
        "gsamples_per_sec": total_samples / wall / 1e9,
        "realtime_factor": audio_seconds / wall,
        "verified_decodes_last_round": f"{ok}/{b}",
        "target": ">100x real-time for 1000 captures (BASELINE.json)",
    }
    print(json.dumps(result, indent=2))
    return 0 if ok == b else 1


if __name__ == "__main__":
    sys.exit(main())
