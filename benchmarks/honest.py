"""Device-resident throughput of ``demod_pack_batch`` for every mode family.

A layer metric, not the served end-to-end one: each config's batch (one
real modulated capture, host-shaped and tiled to ``batch`` rows) is put on
the device once, then the fused receive program is timed with
``benchmarks/_timing.timed`` (median of synced calls after a warm-up).

Reported per config: ``ms`` per dispatch, ``gsps`` = batch * n_samples /
time (GSamples/s), and ``found_all`` — whether every capture's frame sync
fired. The first printed line names the device and the card's power limit.

Usage: python benchmarks/honest.py [--modes QPSK,FSK9600,...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cache")

# Operating points, one per mode family:
# (mode, symbol_rate, batch, log2(n_samples), kwargs)
CONFIGS = {
    "QPSK": (9600, 64, 24, {"cfo_retry": True}),
    "QPSK-nocfo": (9600, 64, 24, {"cfo_retry": False}),
    "BPSK": (9600, 64, 24, {"cfo_retry": True}),
    "8PSK": (9600, 64, 22, {"cfo_retry": True}),
    "DSSS": (9600, 32, 22, {}),
    "FSK1200": (9600, 64, 23, {}),
    "FSK9600": (9600, 64, 23, {}),
    "FSK19200": (9600, 64, 23, {}),
    "OFDM4": (9600, 32, 22, {}),
    "OFDM8": (9600, 32, 22, {}),
    "NEURAL": (9600, 16, 22, {}),
    "HELLSCHREIBER": (9600, 32, 22, {}),
}


def _signal(mode: str, symbol_rate: int, n_samples: int) -> np.ndarray:
    """One real modulated capture for ``mode``, tiled to n_samples (cached)."""
    base = mode.split("-")[0]
    path = os.path.join(CACHE_DIR, f"honest_sig_{base}_{symbol_rate}.npy")
    if os.path.exists(path):
        wave = np.load(path)
    else:
        from audio_modem_radio.framing import crc32, pack_frame
        from audio_modem_radio.modem import modulate

        rng = np.random.default_rng(0)
        if base in ("HELLSCHREIBER", "FELD_HELL", "SLOW_HELL"):
            text = "".join(chr(c) for c in rng.integers(33, 127, 512))
            wave = np.asarray(modulate(base, text.encode(), symbol_rate), np.float32)
        else:
            payload = rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
            framed = pack_frame("bench.bin", payload, 0, 1, len(payload), crc32(payload))
            wave = np.asarray(modulate(base, framed, symbol_rate), np.float32)
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.save(path, wave)
    reps = int(np.ceil(n_samples / len(wave)))
    return np.tile(wave, reps)[:n_samples]


def measure(mode: str, symbol_rate: int, batch: int, n_samples: int, **kwargs) -> dict:
    import jax

    from _timing import timed
    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch

    base = mode.split("-")[0]
    sig = _signal(base, symbol_rate, n_samples)
    one = host_shape_batch(sig[None], base, symbol_rate)[0]
    x = jax.device_put(np.ascontiguousarray(np.broadcast_to(one, (batch,) + one.shape)))

    def dispatch():
        return demod_pack_batch(x, base, symbol_rate, **kwargs)

    sec = timed(dispatch)
    out = dispatch()
    return {
        "mode": mode,
        "batch": batch,
        "n_samples": n_samples,
        "kwargs": kwargs,
        "ms": sec * 1e3,
        "gsps": batch * n_samples / sec / 1e9,
        "found_all": bool(np.asarray(out[2]).all()),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default=",".join(CONFIGS))
    ap.add_argument("--batch", type=int, default=0, help="override the per-config batch size")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "honest_results.json"))
    args = ap.parse_args()

    from _timing import device_header
    from audio_modem_radio.utils.runtime import configure_compile_cache

    configure_compile_cache()
    header = device_header()
    results = []
    for mode in args.modes.split(","):
        mode = mode.strip()
        srate, b, p, kw = CONFIGS[mode]
        if args.batch:
            b = args.batch
        try:
            r = measure(mode, srate, b, 1 << p, **kw)
        except Exception as e:  # record, keep sweeping
            r = {"mode": mode, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(r), flush=True)
        results.append(r)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({**header, "results": results, "methodology": "median of synced calls"}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
