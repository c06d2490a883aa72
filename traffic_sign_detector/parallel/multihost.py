"""Multi-host input feeding over DCN (SURVEY.md §2.5, last row).

The reference is a single process reading one directory (`Deteción de
Objetos/source.py:95-108`); scaling the frame stream past one host needs
each host to decode a *disjoint* slice of the dataset and feed only the
mesh shards it owns, with DCN carrying nothing but the `jax.distributed`
control plane — frames ride each host's own PCIe to its local devices.

Three pieces, composable and individually testable:

* :func:`initialize_distributed` — `jax.distributed.initialize` behind a
  flag (env or explicit args); no-op for single-process runs so the same
  CLI works on one host.
* :func:`host_shard_files` — deterministic disjoint partition of the file
  list. Every host gets the same number of *batches* (SPMD requires every
  process to dispatch the same program sequence), padding its tail with
  repeats of its last file; pad slots carry the name ``"__pad__"`` so the
  collector drops their results exactly like the single-host tail pad
  (`data/prefetch.py`).
* :func:`multihost_batched_frames` — per-host decode-ahead
  (`data.prefetch.batched_frames`) composed with
  `jax.make_array_from_process_local_data`, which assembles a globally
  batch-sharded array from each host's local shard without any cross-host
  data movement.

Single-process validation: all three run unchanged with process_count=1
(the global batch is the local batch), and the sharding math is pure host
logic exercised for arbitrary simulated host counts in
`tests/test_parallel.py`.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import batch_sharding


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Wire up `jax.distributed` for a multi-host run; returns True if done.

    Arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); with no coordinator configured this is a no-op
    (single-host run) so callers can invoke it unconditionally.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def host_shard_files(
    files: list[str],
    batch_size: int,
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """This host's disjoint slice of ``files``, padded to equal batch count.

    ``batch_size`` is the *per-host* (local) batch size.  The split is
    contiguous (host 0 takes the first ceil(N/P) files, ...) so each host's
    decode stream stays sequential on disk; every host is padded (repeating
    its last file, or file 0 for an empty tail shard) to the globally
    maximal shard length rounded up to a full batch, guaranteeing all hosts
    yield the same number of batches.
    """
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    per = -(-len(files) // process_count)  # ceil
    shard = files[process_index * per : (process_index + 1) * per]
    target = -(-per // batch_size) * batch_size
    filler = shard[-1] if shard else files[0]
    return shard + [filler] * (target - len(shard))


def global_batch_from_local(mesh: Mesh, local: np.ndarray) -> jax.Array:
    """Assemble a globally batch-sharded array from this host's local batch.

    The global batch axis is ``local.shape[0] * process_count``; each host
    contributes only the shards its addressable devices own (zero
    host-to-host frame traffic).
    """
    sharding = batch_sharding(mesh)
    return jax.make_array_from_process_local_data(sharding, local)


def multihost_batched_frames(
    directory: str,
    files: list[str],
    local_batch_size: int,
    mesh: Mesh,
    prefetch: int = 2,
    process_index: int | None = None,
    process_count: int | None = None,
):
    """Yield (global_frames, local_names) for this host's slice of ``files``.

    ``global_frames`` is a `jax.Array` sharded along the batch axis of
    ``mesh`` whose addressable shards were decoded and uploaded by this
    host; ``local_names`` names this host's slots (pad slots are
    ``"__pad__"``).  Result collection is per-host: each host scores /
    serializes the detections of its own slots and a final psum (or
    host-side gather) merges metrics, mirroring the single-host flow.
    """
    from ..data.prefetch import batched_frames

    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    shard = host_shard_files(files, local_batch_size, process_index, process_count)
    per = -(-len(files) // process_count)
    n_real = max(0, min(per, len(files) - process_index * per))
    done = 0
    for frames, names in batched_frames(
        directory, shard, local_batch_size, prefetch=prefetch
    ):
        # host-level pad slots decode a repeated real file; rename them so
        # collectors drop their results like the single-host tail pad
        names = [
            n if done + i < n_real else "__pad__" for i, n in enumerate(names)
        ]
        done += len(names)
        yield global_batch_from_local(mesh, np.asarray(frames)), names
