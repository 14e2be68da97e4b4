"""Device timing shared by the benchmark scripts.

JAX dispatches asynchronously: a call returns before the device has run it.
Every timed region here therefore ends in ``jax.block_until_ready`` on the
outputs it produced. :func:`timed` compiles and warms the program first and
reports the median of ``reps`` individually synced calls.

:func:`device_header` is the first line every script prints: the device JAX
found and the card's name and power limit (a card set below its maximum
power runs slower under load, so the limit belongs beside every number).
It fails when JAX found no GPU — a CPU timing is not a device number.
"""

from __future__ import annotations

import json
import time

import numpy as np


def timed(fn, *args, reps: int = 8) -> float:
    """Median seconds per call of ``fn(*args)``, each call synced."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_header() -> dict:
    """Print and return the device line; RuntimeError when no GPU."""
    from audio_modem_radio.utils.runtime import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    info = {"device": dev, "card": card_name_and_power_limit()}
    print(json.dumps(info), flush=True)
    return info
