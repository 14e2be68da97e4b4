"""Device mesh helpers for sharded batch DSP.

The reference has no parallelism at all (SURVEY.md §2: single-threaded DSP,
Qt threads for UI only). The rebuild's scaling axis is data parallelism
over independent audio captures: a 1-D ``Mesh`` over all available devices
with the batch dimension sharded across it. No cross-sample collectives are
needed in the demod path (each capture is independent); metric reductions ride
``psum`` inside shard_map when requested.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def get_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over ``n_devices`` (default: all devices)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def get_2d_mesh(data: int, model: int, devices: Optional[Sequence] = None) -> Mesh:
    """(data, model) mesh for the neural-modem training path (dp x tp)."""
    devs = list(devices if devices is not None else jax.devices())
    if data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {len(devs)}")
    grid = np.asarray(devs[: data * model]).reshape(data, model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the data axis of the mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading axis to a multiple of ``multiple`` (sharding requires
    the batch to divide evenly across devices)."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)
