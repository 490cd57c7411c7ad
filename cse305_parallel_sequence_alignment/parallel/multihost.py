"""Multi-host execution helpers (DCN layer).

The reference is a single shared-memory process (SURVEY.md §5: no
distributed runtime at all); this module is the framework's multi-host
story for the throughput mode (pair streams fanned out across hosts):

- ``init_distributed``: fail-fast wrapper over ``jax.distributed`` —
  per-host processes join a coordinator, after which ``jax.devices()``
  spans the slice and the ``data``/``seq`` meshes in parallel/mesh.py
  become global. Safe no-op for single-process runs.
- ``host_shard``: deterministic striping of a work list across hosts;
  each host streams its own input shard (pure functions make re-running a
  lost host's shard the recovery story — see harness/stream.py).
"""

from __future__ import annotations

import os

import jax


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None,
                     initialization_timeout=None):
    """Initialize multi-host JAX, or no-op when single-process.

    Args come from the environment when not given (JAX's standard
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID set by launchers).
    Raises RuntimeError with a clear message on failure instead of
    hanging workers (fail-fast policy, SURVEY.md §5).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process: nothing to do
    try:
        kw = {}
        if initialization_timeout is not None:
            kw["initialization_timeout"] = initialization_timeout
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids, **kw)
    except Exception as e:  # noqa: BLE001 - re-raise with context
        raise RuntimeError(
            f"jax.distributed.initialize failed (coordinator="
            f"{coordinator_address}, num_processes={num_processes}, "
            f"process_id={process_id}): {e}") from e
    return True


def process_info():
    """(process_index, process_count) of this host."""
    return jax.process_index(), jax.process_count()


def host_shard(count, process_index=None, process_count=None):
    """Indices of the work items this host owns (contiguous blocks, the
    deterministic split every host can compute locally)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    base = count // process_count
    extra = count % process_count
    start = process_index * base + min(process_index, extra)
    size = base + (1 if process_index < extra else 0)
    return range(start, start + size)
