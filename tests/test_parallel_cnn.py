"""SPMD CNN training over the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from traffic_sign_detector.models import cnn_detector as cd
from traffic_sign_detector.models import cnn_train as ct
from traffic_sign_detector.parallel.cnn import (
    make_spmd_cnn_train_step,
    put_sharded_cnn_dataset,
    shard_cnn_dataset,
)
from traffic_sign_detector.parallel.mesh import data_mesh

CFG = cd.CNNDetectorConfig()


def _toy_data(n_frames=6, hw=520):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (n_frames, hw, hw, 3), dtype=np.uint8)
    boxes = np.zeros((n_frames, ct.MAX_GT, 4), np.float32)
    cls = np.zeros((n_frames, ct.MAX_GT), np.int32)
    pos = []
    for i in range(n_frames):
        boxes[i, 0] = (200, 200, 260, 260)
        cls[i, 0] = (i % cd.NUM_CLASSES) + 1
        pos.append((i, 230.0, 230.0))
    return {"frames": frames, "boxes": boxes, "cls": cls,
            "pos": np.asarray(pos, np.float32)}


def test_shard_cnn_dataset_local_indices():
    data = _toy_data(n_frames=6)
    sharded = shard_cnn_dataset(data, 4)      # 6 -> pad to 8, 2 per shard
    assert sharded["frames"].shape[0] == 8
    p = sharded["pos"].reshape(4, -1, 3)
    # every local frame index must address inside the shard
    assert p[:, :, 0].max() < 2
    # each shard's positives point at frames that really hold a sign there
    for s in range(4):
        for li, cx, cy in np.asarray(p[s]):
            gi = s * 2 + int(li)
            b = sharded["boxes"][gi, 0]
            assert b[0] <= cx <= b[2] and b[1] <= cy <= b[3]


@pytest.mark.slow
def test_spmd_cnn_train_step_runs_and_reduces():
    mesh = data_mesh(8)
    data = shard_cnn_dataset(_toy_data(n_frames=8), 8)
    ddata = put_sharded_cnn_dataset(mesh, data)
    cfg = ct.TrainConfig(batch_size=1, steps=10, warmup_steps=2, lr=1e-3,
                         pos_fraction=1.0)
    step = jax.jit(make_spmd_cnn_train_step(mesh, CFG, cfg))
    params = cd.init_params(0)
    opt_state = ct.make_optimizer(cfg).init(params)
    losses = []
    for s in range(cfg.steps):
        params, opt_state, m = step(params, opt_state, ddata, jnp.int32(s))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    # params stayed replicated (single value per leaf)
    leaf = jax.tree_util.tree_leaves(params)[0]
    assert not leaf.is_deleted()
