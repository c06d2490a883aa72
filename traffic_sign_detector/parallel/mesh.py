"""Device mesh + sharding helpers for data-parallel scale-out.

The reference is single-process with per-image Python loops (`SURVEY.md`
§2.5: no DP/TP/PP anywhere); the data-parallel scaling story is a 1-D ``data``
mesh over which the frame batch is sharded.  Detection/recognition forward
passes are embarrassingly parallel per frame, so sharding the batch axis is
the whole layout; metric/statistic reductions ride psum (see
:mod:`.train`).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the batch ("data") axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dim across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, array) -> jax.Array:
    """Place a host batch onto the mesh, sharded along dim 0."""
    return jax.device_put(array, batch_sharding(mesh))


def sharded_detect_fn(mesh: Mesh, cfg, detect_batch_fn):
    """jit a per-batch detection fn with batch-sharded inputs/outputs.

    detect_batch_fn: (frames [B,H,W,3], red_t, blue_t) -> pytree of [B,...]
    The per-frame pipeline has no cross-frame dependence, so XLA partitions
    it fully along the data axis with zero collectives.
    """
    bs = batch_sharding(mesh)
    rep = replicated(mesh)
    return jax.jit(
        detect_batch_fn,
        in_shardings=(bs, rep, rep),
        out_shardings=bs,
    )


def sharded_recognize_fn(mesh: Mesh, cfg, features: str, clf_kind: str,
                         knn_k: int = 4):
    """jit the recognition inference batch with batch-sharded frames.

    Same zero-collective SPMD shape as :func:`sharded_detect_fn`:
    classifier arrays (LDA head stacks or the KNN train set) are
    replicated, the frame batch and every per-frame output shard along
    the data axis.
    """
    from ..models.rec_pipeline import recognize_batch

    bs = batch_sharding(mesh)
    rep = replicated(mesh)
    return jax.jit(
        lambda frames, clf_arrays: recognize_batch(
            frames, clf_arrays, cfg, features, clf_kind, knn_k
        ),
        in_shardings=(bs, rep),
        out_shardings=bs,
    )
