"""Benchmark: batched QPSK demodulation throughput (Msamples/s) on one GPU.

Prints the device line (``benchmarks/_timing.device_header``: JAX's device,
the card's name and power limit), then ONE JSON line:
{"metric", "value", "unit", ...extras}.

Workload: the BASELINE.json headline config — batched DQPSK @ 9600 Bd,
96 kHz captures — through ``demod_pack_batch``, the fused demod + sync +
pack program the decode pipeline runs, with the captures host-shaped into
blocked rows as ``decode_sample_batch`` does. The batch is put on the
device once; each timed call ends in ``jax.block_until_ready``. This is the
device-resident program rate (a layer metric); the served path from WAV
files is exercised by chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks"))


def _make_signal(n_samples: int, baud: int = 9600) -> np.ndarray:
    """A real QPSK transmission (framed random payload), tiled to n_samples."""
    from audio_modem_radio.framing import crc32, pack_frame
    from audio_modem_radio.modem import modulate

    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
    framed = pack_frame("bench.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate("QPSK", framed, baud), np.float32)
    reps = int(np.ceil(n_samples / len(wave)))
    return np.tile(wave, reps)[:n_samples]


def bench_demod(batch: int, n_samples: int, baud: int, cfo_retry: bool = True) -> float:
    """Msamples/s through the fused batched demod on the default device."""
    import jax

    from _timing import timed
    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch

    one = host_shape_batch(_make_signal(n_samples, baud)[None], "QPSK", baud)[0]
    x = jax.device_put(np.ascontiguousarray(np.broadcast_to(one, (batch,) + one.shape)))
    sec = timed(lambda: demod_pack_batch(x, "QPSK", baud, cfo_retry=cfo_retry))
    return batch * n_samples / sec / 1e6


def main() -> None:
    from _timing import device_header
    from audio_modem_radio.utils.runtime import configure_compile_cache

    configure_compile_cache()
    header = device_header()
    baud = 9600
    batch, n_samples = 64, 1 << 24  # 1.07 Gsamples (4.3 GB f32) per call

    # Headline = the production default pipeline, CFO robustness on (blind
    # derotation + quarter-turn sync retry); cfo_retry off for comparison.
    value = bench_demod(batch, n_samples, baud)
    value_fast = bench_demod(batch, n_samples, baud, cfo_retry=False)
    print(json.dumps({
        "metric": "demod_msamples_per_sec",
        "value": value,
        "unit": "Msamples/s",
        "config": f"QPSK@{baud}Bd 96kHz, batch={batch}x{n_samples}, cfo_retry=on (default)",
        "msamples_per_sec_cfo_off": value_fast,
        **header,
    }))


if __name__ == "__main__":
    main()
