"""SPMD data-parallel training for the CNN sign detector.

The gradient counterpart of ``parallel/train.py`` (which distributes the
closed-form LDA fit): the frame dataset is SHARDED over the data mesh —
each device holds ``N / n_devices`` frames in its own HBM and samples its
sub-batch of augmented crops locally, so dataset capacity scales linearly
with the mesh — and the per-device gradients are ``psum``-averaged before a replicated optimizer step.  No host is involved inside the loop;
on a multi-host mesh each host only ever touches its own frame shard
(the per-host input-feed contract of ``parallel/feed.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.cnn_detector import CNNDetectorConfig, forward
from ..models.cnn_train import (
    CROP,
    TrainConfig,
    _sample_crop,
    centernet_loss,
    make_optimizer,
    make_targets,
)
from .mesh import DATA_AXIS


def shard_cnn_dataset(data: dict, n_shards: int) -> dict:
    """Split a build_dataset() dict into equal per-device shards.

    Frames are padded (by repeating the first frames) to a multiple of
    ``n_shards``; each shard's positive table is rebuilt with LOCAL frame
    indices and padded to a common length so shapes stay static under SPMD.
    """
    frames, boxes, cls = data["frames"], data["boxes"], data["cls"]
    n = frames.shape[0]
    per = -(-n // n_shards)
    pad = per * n_shards - n
    if pad:
        idx = np.concatenate([np.arange(n), np.arange(pad) % n])
        frames, boxes, cls = frames[idx], boxes[idx], cls[idx]

    shard_pos: list[np.ndarray] = []
    for s in range(n_shards):
        rows = []
        for li in range(per):
            gi = s * per + li
            for b, c in zip(boxes[gi], cls[gi]):
                if c > 0:
                    rows.append((li, (b[0] + b[2]) / 2, (b[1] + b[3]) / 2))
        shard_pos.append(np.asarray(rows, np.float32).reshape(-1, 3))
    p_max = max(1, max(p.shape[0] for p in shard_pos))
    padded = []
    for p in shard_pos:
        if p.shape[0] == 0:
            # a shard with no signs samples its "positive" crops uniformly
            p = np.asarray([[0, frames.shape[2] / 2, frames.shape[1] / 2]],
                           np.float32)
        reps = -(-p_max // p.shape[0])
        padded.append(np.tile(p, (reps, 1))[:p_max])
    return {
        "frames": frames,
        "boxes": boxes,
        "cls": cls,
        "pos": np.stack(padded).reshape(n_shards * p_max, 3),
    }


def put_sharded_cnn_dataset(mesh, data: dict) -> dict:
    """Device-put each array sharded over the mesh's data axis (dim 0)."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return {k: jax.device_put(jnp.asarray(v), sharding)
            for k, v in data.items()}


def make_spmd_cnn_train_step(mesh, model_cfg: CNNDetectorConfig,
                             cfg: TrainConfig):
    """Jittable (params, opt_state, sharded_data, step) -> (params, opt_state, metrics).

    params/opt_state replicated; data sharded over DATA_AXIS.  Per-device
    batch is ``cfg.batch_size`` crops, so the GLOBAL batch is
    ``batch_size * n_devices`` (matching the single-device recipe requires
    dividing batch_size by the mesh size).
    """
    tx = make_optimizer(cfg)
    grid = CROP // model_cfg.stride
    n_dev = mesh.devices.size

    def loss_fn(params, imgs, boxes, cls):
        out = forward(params, imgs, model_cfg.compute_dtype())
        tgt = jax.vmap(partial(make_targets, grid_h=grid, grid_w=grid,
                               stride=model_cfg.stride))(boxes, cls)
        return centernet_loss(out, tgt, cfg)

    def local_grads(params, frames, boxes, cls, pos, step):
        dev = jax.lax.axis_index(DATA_AXIS)
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step), dev)
        keys = jax.random.split(key, cfg.batch_size)
        imgs, cboxes, ccls = jax.vmap(partial(
            _sample_crop, frames=frames, boxes=boxes, cls=cls, pos=pos,
            min_zoom=cfg.min_zoom, max_zoom=cfg.max_zoom,
            pos_fraction=cfg.pos_fraction))(keys)
        (loss, parts), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, imgs, cboxes, ccls)
        grads = jax.lax.pmean(grads, DATA_AXIS)
        metrics = jax.lax.pmean({"loss": loss, **parts}, DATA_AXIS)
        return grads, metrics

    sharded = shard_map(
        local_grads, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS), P()),
        out_specs=(P(), P()),
    )

    def train_step(params, opt_state, data, step):
        grads, metrics = sharded(params, data["frames"], data["boxes"],
                                 data["cls"], data["pos"], step)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    del n_dev
    return train_step
