"""Multi-host (DCN) batch decode: scale the capture farm past one host.

``decode_wav_batch`` assumes one process owning all devices; a pod slice
spans hosts, each owning a subset of chips, coordinated over DCN. The design
keeps DCN entirely OUT of the hot path (SURVEY.md §5: captures are
independent, so the only cross-host traffic is job setup and the final
result gather — there are no cross-sample collectives to ride DCN):

* ``initialize()`` — ``jax.distributed.initialize`` (env-driven under
  standard launchers; explicit args otherwise). Safe no-op single-process.
* ``partition_files(paths)`` — deterministic round-robin split of the global
  WAV list by process index: every host decodes its own shard with its LOCAL
  devices through the existing single-host pipeline. Round-robin (not
  contiguous blocks) balances mixed-length capture sets.
* ``decode_wav_batch_multihost(paths, ...)`` — partition, decode locally,
  then (optionally) all-gather the per-host saved-file manifests through one
  tiny ``process_allgather`` so every host returns the global result list.

Runs unchanged on one process (partition = identity, gather = identity) —
which is how the test suite exercises it; the driver's virtual mesh covers
the single-host sharding underneath.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger("audio_modem_radio")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed; no-op when already initialized or solo.

    Must be the process's FIRST jax touch: any backend-initializing call
    (even ``jax.process_count()``) beforehand makes ``distributed.initialize``
    raise — so this function probes initialization state without touching
    the backend, and only swallows the specific already-initialized error.
    """
    import jax

    try:
        if coordinator_address is None and num_processes is None:
            jax.distributed.initialize()  # env-driven (SLURM/GKE/launcher)
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    except ValueError as exc:
        # No coordinator config anywhere: legitimate single-host run.
        logger.info("jax.distributed not configured (%s); running single-host", exc)
    except RuntimeError as exc:
        if "already" in str(exc).lower():
            return  # initialized earlier in this process — fine
        raise


def partition_files(paths: Sequence[str], process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """This process's shard of the global WAV list (deterministic, disjoint,
    exhaustive across processes)."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return list(paths[pid::n])


def decode_wav_batch_multihost(
    paths: Sequence[str],
    mode: str,
    symbol_rate: int,
    recv_dir: Optional[str] = None,
    registry=None,
    gather_manifest: bool = True,
) -> List[str]:
    """Decode a GLOBAL list of WAVs across all hosts; returns saved paths.

    Each host decodes ``partition_files(paths)`` on its local devices via the
    single-host batched pipeline (local mesh over ``jax.local_devices()``).
    With ``gather_manifest`` every host returns the union of all hosts' saved
    file names (one tiny DCN all-gather); otherwise just the local ones.
    """
    import jax

    from ..decoder import RECV_DIR
    from .batch import decode_wav_batch
    from .mesh import get_mesh

    mine = partition_files(paths)
    saved_local: List[str] = []
    if mine:
        mesh = get_mesh(devices=jax.local_devices())
        results = decode_wav_batch(
            mine, mode, symbol_rate, recv_dir=recv_dir or RECV_DIR, registry=registry,
            mesh=mesh,
        )
        saved_local = [p for r in results for p in r]

    if not gather_manifest or jax.process_count() == 1:
        return saved_local

    # One tiny control-plane all-gather: each host's manifest as JSON bytes,
    # zero-padded to the global max length (no per-path truncation — paths
    # can be long or multibyte). DCN traffic ~KB; captures never cross hosts.
    import json

    from jax.experimental import multihost_utils

    blob = json.dumps(saved_local).encode("utf-8")
    max_len = int(
        multihost_utils.process_allgather(np.asarray([len(blob)], np.int32)).max()
    )
    buf = np.zeros(max_len + 4, np.uint8)
    buf[:4] = np.frombuffer(np.int32(len(blob)).tobytes(), np.uint8)
    buf[4 : 4 + len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = multihost_utils.process_allgather(buf)  # (n_proc, max_len+4)
    out: List[str] = []
    for row in np.asarray(gathered):
        n = int(np.frombuffer(bytes(row[:4]), np.int32)[0])
        if n:
            out.extend(json.loads(bytes(row[4 : 4 + n]).decode("utf-8")))
    return out
