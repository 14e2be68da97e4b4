"""JAX set-up shared by the entry points: compile cache and device checks.

JAX chooses its platform itself and honours ``JAX_PLATFORMS`` (for example
``JAX_PLATFORMS=cpu`` for a host-only run) as it documents; nothing here
overrides that choice.

Compiled programs go to JAX's persistent compilation cache. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this module sets no
other path. Otherwise the cache lives at one fixed path inside the
checkout, :data:`DEFAULT_CACHE_DIR`, so every run of the checkout finds what
the previous one compiled.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory.

    Call before the process compiles its first program."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env  # JAX already took it from the environment
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_summary() -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` of the devices JAX found."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> Dict[str, object]:
    """:func:`device_summary`, or RuntimeError when JAX found no GPU.

    Measurement entry points call this first: a number taken on the CPU
    must never be reported as a device number."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {dev['platform']} ({dev['kind']}); "
            "device measurements need the accelerator"
        )
    return dev


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, one
    line per card (raises when ``nvidia-smi`` is missing or fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
