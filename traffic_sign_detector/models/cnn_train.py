"""Training pipeline for the CNN sign detector — fully device-resident.

The reference trains its detector-side model by averaging mask crops on the
host (``Deteción de Objetos/source.py:330-360``); its recognition trainer
loops scikit-learn on host features.  This trainer is the device-resident
counterpart for the CNN family:

* the ENTIRE training set (643 frames, ~2.1 GB uint8) is uploaded to
  device memory once; after that the host feeds nothing but a step counter,
* crop sampling, scale/color augmentation, target rendering, the forward/
  backward pass and the optimizer update are one jitted function — there is
  no host<->device traffic inside the loop,
* gt.txt boxes ride along as padded [N, MAX_GT, 5] tensors; unmapped GTSDB
  classes (the evaluation protocol's ignore regions,
  ``Reconocimiento de Objetos/evaluar_resultados.py:125-143``) mask the
  heatmap loss instead of being mined as background.

Supervision is the standard CenterNet recipe: penalty-reduced focal loss on
per-class center heatmaps with Gaussian-splatted targets, L1 on sub-cell
offsets and box sizes at the positive cells.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

# flax is a training-only dependency: the BatchNorm twin below is a flax
# module; inference (cnn_detector, cnn_quant) never imports this module.
import flax.linen as nn

from ..data.gt import load_ground_truth, boxes_by_file
from ..data.images import list_frame_files, load_image_bgr
from .cnn_detector import (
    NUM_CLASSES,
    STRIDE,
    CNNDetectorConfig,
)

MAX_GT = 8          # max gt boxes per GTSDB frame is 6
CROP = 320          # training crop fed to the network
SLICE = 448         # raw slice taken before scale jitter (>= CROP / min_zoom)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    steps: int = 4000
    lr: float = 2.5e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    pos_fraction: float = 0.7     # crops centered near a gt sign
    min_zoom: float = 0.75        # output px per input px
    max_zoom: float = 1.4
    size_loss_weight: float = 0.1
    offset_loss_weight: float = 1.0
    seed: int = 0


# ---------------------------------------------------------------------------
# Host-side dataset assembly (runs once)
# ---------------------------------------------------------------------------


def build_dataset(train_dir: str, gt_name: str = "gt.txt"):
    """Load every frame + gt into padded numpy tensors.

    Returns dict of numpy arrays:
      frames  [N, H, W, 3] uint8 (BGR)
      boxes   [N, MAX_GT, 4] float32 xyxy
      cls     [N, MAX_GT] int32  (1..6 sign, -1 ignore, 0 padding)
      pos     [P, 3] float32 (frame_idx, cx, cy) one row per mapped gt box
    """
    gt = boxes_by_file(load_ground_truth(os.path.join(train_dir, gt_name)))
    files = list_frame_files(train_dir)
    frames, all_boxes, all_cls, pos = [], [], [], []
    for i, fname in enumerate(files):
        img = load_image_bgr(os.path.join(train_dir, fname))
        frames.append(img)
        bxs = np.zeros((MAX_GT, 4), np.float32)
        cls = np.zeros((MAX_GT,), np.int32)
        for j, b in enumerate(gt.get(fname, [])[:MAX_GT]):
            bxs[j] = (b.x1, b.y1, b.x2, b.y2)
            cls[j] = b.class_id
            if b.class_id > 0:
                pos.append((i, (b.x1 + b.x2) / 2.0, (b.y1 + b.y2) / 2.0))
        all_boxes.append(bxs)
        all_cls.append(cls)
    return {
        "frames": np.stack(frames),
        "boxes": np.stack(all_boxes),
        "cls": np.stack(all_cls),
        "pos": np.asarray(pos, np.float32),
    }


# ---------------------------------------------------------------------------
# On-device crop sampling + augmentation
# ---------------------------------------------------------------------------


def _sample_crop(key, frames, boxes, cls, pos, min_zoom, max_zoom,
                 pos_fraction):
    """Sample ONE augmented crop; vmapped over the batch inside train_step."""
    n, img_h, img_w, _ = frames.shape
    (k_src, k_frame, k_pos, k_jit, k_zoom, k_uv, k_bright, k_contrast,
     k_win) = jax.random.split(key, 9)

    # --- choose a frame and a slice origin -------------------------------
    use_pos = jax.random.uniform(k_src) < pos_fraction
    pidx = jax.random.randint(k_pos, (), 0, pos.shape[0])
    pframe = pos[pidx, 0].astype(jnp.int32)
    # center the slice near the chosen sign, jittered so it lands anywhere
    # inside the crop (not always dead-center)
    jit = jax.random.uniform(k_jit, (2,), minval=-CROP / 3, maxval=CROP / 3)
    pcx = pos[pidx, 1] + jit[0]
    pcy = pos[pidx, 2] + jit[1]
    rframe = jax.random.randint(k_frame, (), 0, n)
    ruv = jax.random.uniform(k_uv, (2,))
    fidx = jnp.where(use_pos, pframe, rframe)
    ox = jnp.where(use_pos, pcx - SLICE / 2, ruv[0] * (img_w - SLICE))
    oy = jnp.where(use_pos, pcy - SLICE / 2, ruv[1] * (img_h - SLICE))
    ox = jnp.clip(ox, 0, img_w - SLICE).astype(jnp.int32)
    oy = jnp.clip(oy, 0, img_h - SLICE).astype(jnp.int32)

    raw = jax.lax.dynamic_slice(
        frames, (fidx, oy, ox, jnp.int32(0)), (1, SLICE, SLICE, 3))[0]

    # --- scale jitter: map a zoom-dependent subwindow to CROP^2 ----------
    zoom = jax.random.uniform(k_zoom, (), minval=min_zoom, maxval=max_zoom)
    win = CROP / zoom                      # input pixels covered by the crop
    max_uv = jnp.maximum(SLICE - win, 0.0)
    uv = jax.random.uniform(k_win, (2,)) * max_uv
    img = jax.image.scale_and_translate(
        raw.astype(jnp.float32), (CROP, CROP, 3), (0, 1),
        jnp.array([zoom, zoom], jnp.float32),
        jnp.array([-uv[1] * zoom, -uv[0] * zoom], jnp.float32),
        method="linear")

    # --- color jitter -----------------------------------------------------
    gain = jax.random.uniform(k_contrast, (), minval=0.7, maxval=1.3)
    bias = jax.random.uniform(k_bright, (), minval=-30.0, maxval=30.0)
    img = jnp.clip(img * gain + bias, 0, 255).astype(jnp.uint8)

    # --- transform this frame's gt into crop coordinates ------------------
    fb = boxes[fidx]                                        # [MAX_GT, 4]
    fc = cls[fidx]                                          # [MAX_GT]
    x1 = (fb[:, 0] - ox - uv[0]) * zoom
    y1 = (fb[:, 1] - oy - uv[1]) * zoom
    x2 = (fb[:, 2] - ox - uv[0]) * zoom
    y2 = (fb[:, 3] - oy - uv[1]) * zoom
    cx = (x1 + x2) / 2
    cy = (y1 + y2) / 2
    inside = (cx >= 0) & (cx < CROP) & (cy >= 0) & (cy < CROP)
    big_enough = ((x2 - x1) >= 6) & ((y2 - y1) >= 6)
    keep = inside & big_enough & (fc != 0)
    out_cls = jnp.where(keep, fc, 0)
    out_boxes = jnp.stack([x1, y1, x2, y2], axis=-1)
    return img, out_boxes, out_cls


# ---------------------------------------------------------------------------
# Target rendering (device, static shapes)
# ---------------------------------------------------------------------------


def _gaussian_radius(w, h, min_overlap=0.7):
    """CenterNet radius rule (Zhou et al. 2019, eq. from CornerNet)."""
    a1 = 1.0
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    sq1 = jnp.sqrt(jnp.maximum(b1 * b1 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2
    a2 = 4.0
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    sq2 = jnp.sqrt(jnp.maximum(b2 * b2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    sq3 = jnp.sqrt(jnp.maximum(b3 * b3 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / (2 * a3)
    return jnp.maximum(jnp.minimum(jnp.minimum(r1, r2), r3), 1.0)


def make_targets(boxes, cls, grid_h: int, grid_w: int, stride: int = STRIDE):
    """Render one crop's gt into CenterNet targets.

    boxes [M,4] crop pixels, cls [M] (0 pad, -1 ignore, 1..6 sign).
    Returns (hm [H,W,C], wh [H,W,2], off [H,W,2], pos_mask [H,W],
    loss_mask [H,W,C]); ignore boxes zero the loss_mask under their extent.
    ``stride`` must match the model's head-grid stride (cfg.stride).
    """
    ys = jnp.arange(grid_h, dtype=jnp.float32)
    xs = jnp.arange(grid_w, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")        # [H,W]

    w = (boxes[:, 2] - boxes[:, 0]) / stride            # grid units
    h = (boxes[:, 3] - boxes[:, 1]) / stride
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / stride
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / stride
    valid = cls > 0

    # positive cells: the (clamped) integer center of each valid box.  The
    # Gaussian is splatted around the INTEGER cell (standard CenterNet) so
    # the center cell's target is exactly 1.0 — the focal loss's positive
    # test keys off that; the offset head carries the fractional part.
    icx = jnp.clip(cx.astype(jnp.int32), 0, grid_w - 1)
    icy = jnp.clip(cy.astype(jnp.int32), 0, grid_h - 1)

    radius = _gaussian_radius(w, h)
    sigma2 = jnp.maximum((2 * radius + 1) / 6, 1e-3) ** 2
    d2 = ((gx[None] - icx[:, None, None].astype(jnp.float32)) ** 2
          + (gy[None] - icy[:, None, None].astype(jnp.float32)) ** 2)
    g = jnp.exp(-d2 / (2 * sigma2[:, None, None]))      # [M,H,W]
    g = jnp.where(valid[:, None, None], g, 0.0)
    onehot = jax.nn.one_hot(jnp.clip(cls - 1, 0, NUM_CLASSES - 1),
                            NUM_CLASSES) * valid[:, None]
    hm = jnp.max(g[:, :, :, None] * onehot[:, None, None, :], axis=0)
    cell_onehot = (jax.nn.one_hot(icy, grid_h)[:, :, None]
                   * jax.nn.one_hot(icx, grid_w)[:, None, :])    # [M,H,W]
    cell_onehot = cell_onehot * valid[:, None, None]
    pos_mask = jnp.max(cell_onehot, axis=0)
    # later boxes win collisions (sum then renormalize would blur; max picks 1)
    wh = jnp.einsum("mhw,mc->hwc", cell_onehot,
                    jnp.stack([w, h], -1) * valid[:, None])
    off = jnp.einsum("mhw,mc->hwc", cell_onehot,
                     jnp.stack([cx - icx, cy - icy], -1) * valid[:, None])
    denom = jnp.maximum(jnp.sum(cell_onehot, axis=0), 1.0)[..., None]
    wh = wh / denom
    off = off / denom

    # ignore regions: zero the heatmap loss everywhere an unmapped gt lives
    ign = cls == -1
    ix1 = jnp.floor(boxes[:, 0] / stride)
    iy1 = jnp.floor(boxes[:, 1] / stride)
    ix2 = jnp.ceil(boxes[:, 2] / stride)
    iy2 = jnp.ceil(boxes[:, 3] / stride)
    covered = ((gx[None] >= ix1[:, None, None]) & (gx[None] <= ix2[:, None, None])
               & (gy[None] >= iy1[:, None, None]) & (gy[None] <= iy2[:, None, None]))
    covered = covered & ign[:, None, None]
    loss_mask = jnp.where(jnp.any(covered, axis=0)[..., None], 0.0, 1.0)
    loss_mask = jnp.broadcast_to(loss_mask, (grid_h, grid_w, NUM_CLASSES))
    return hm, wh, off, pos_mask, loss_mask


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def centernet_loss(outputs, targets, cfg: TrainConfig):
    hm_t, wh_t, off_t, pos_mask, loss_mask = targets
    logits = outputs["hm"]
    p = jax.nn.sigmoid(logits)
    # penalty-reduced focal (CenterNet): positives are cells where hm_t == 1
    pos = (hm_t >= 0.9999).astype(jnp.float32)
    log_p = jax.nn.log_sigmoid(logits)
    log_np = jax.nn.log_sigmoid(-logits)
    pos_loss = -((1 - p) ** 2) * log_p * pos
    neg_loss = -((1 - hm_t) ** 4) * (p ** 2) * log_np * (1 - pos)
    n_pos = jnp.maximum(jnp.sum(pos), 1.0)
    hm_loss = jnp.sum((pos_loss + neg_loss) * loss_mask) / n_pos

    pm = pos_mask[..., None]
    n_cells = jnp.maximum(jnp.sum(pos_mask), 1.0)
    wh_loss = jnp.sum(jnp.abs(outputs["size"] - wh_t) * pm) / n_cells
    off_loss = jnp.sum(jnp.abs(outputs["off"] - off_t) * pm) / n_cells
    total = (hm_loss + cfg.size_loss_weight * wh_loss
             + cfg.offset_loss_weight * off_loss)
    return total, {"hm": hm_loss, "wh": wh_loss, "off": off_loss}


# ---------------------------------------------------------------------------
# v3 training twin: BatchNorm at train time, folded away at export
# ---------------------------------------------------------------------------


class SignCenterNetV3Train(nn.Module):
    """BatchNorm twin of the inference network (``cnn_detector.forward``).

    Same conv topology as the inference network but every trunk conv
    is bias-free and followed by BatchNorm.  At export
    ``fold_v3_batchnorm`` folds each BN's affine + running statistics into
    the preceding conv's kernel/bias, producing the inference module's
    parameter tree exactly — the product path then carries no norm layers
    at all (a GroupNorm's statistics are data-dependent at inference, so
    it could not be folded away).
    """

    cfg: CNNDetectorConfig = field(default_factory=lambda: CNNDetectorConfig(arch="v3"))

    @nn.compact
    def __call__(self, frames_u8, train: bool = True):
        dt = self.cfg.compute_dtype()
        x = frames_u8.astype(dt) * jnp.asarray(1.0 / 255.0, dt) \
            - jnp.asarray(0.5, dt)

        def block(x, feats, kernel, strides):
            x = nn.Conv(feats, kernel, strides=strides, use_bias=False,
                        dtype=dt)(x)
            x = nn.BatchNorm(use_running_average=not train,
                             dtype=jnp.float32)(x)
            return nn.relu(x)

        x = block(x, 64, (8, 8), (8, 8))      # patchify, s8
        x = block(x, 128, (3, 3), (2, 2))     # s16
        x = block(x, 128, (3, 3), (1, 1))
        fin = block(x, 128, (3, 3), (1, 1))
        hm = nn.Conv(NUM_CLASSES, (3, 3), dtype=dt,
                     bias_init=nn.initializers.constant(-4.59))(
                         fin).astype(jnp.float32)
        size = nn.Conv(2, (3, 3), dtype=dt)(fin).astype(jnp.float32)
        off = nn.Conv(2, (3, 3), dtype=dt)(fin).astype(jnp.float32)
        return {"hm": hm, "size": size, "off": off}


def fold_v3_batchnorm(params: dict, batch_stats: dict) -> dict:
    """Fold BatchNorm into the convs: train-params -> inference-params.

    y = BN(conv(x)) = conv(x) * g/sqrt(v+eps) + (b - m*g/sqrt(v+eps)), so
    kernel' = kernel * g/sqrt(v+eps) (per output channel) and
    bias' = b - m*g/sqrt(v+eps).  Head convs (Conv_4..6) pass through.
    Returns the exact parameter tree ``cnn_detector.forward`` takes.
    """
    eps = 1e-5  # flax nn.BatchNorm default
    folded: dict = {}
    for i in range(4):
        conv = params[f"Conv_{i}"]
        bn = params[f"BatchNorm_{i}"]
        stats = batch_stats[f"BatchNorm_{i}"]
        scale = bn["scale"] / jnp.sqrt(stats["var"] + eps)
        folded[f"Conv_{i}"] = {
            "kernel": conv["kernel"] * scale,          # broadcasts over O
            "bias": bn["bias"] - stats["mean"] * scale,
        }
    for i in range(4, 7):
        folded[f"Conv_{i}"] = dict(params[f"Conv_{i}"])
    return jax.tree.map(jnp.asarray, folded)


def make_v3_train_step(model_cfg: CNNDetectorConfig, cfg: TrainConfig):
    """Jittable (params, stats, opt_state, data, step) -> (params, stats,
    opt_state, metrics): one optimizer step of the BatchNorm twin."""
    model = SignCenterNetV3Train(model_cfg)
    tx = make_optimizer(cfg)
    grid = CROP // model_cfg.stride

    def loss_fn(params, stats, imgs, boxes, cls):
        out, upd = model.apply({"params": params, "batch_stats": stats},
                               imgs, train=True, mutable=["batch_stats"])
        tgt = jax.vmap(partial(make_targets, grid_h=grid, grid_w=grid,
                               stride=model_cfg.stride))(boxes, cls)
        total, parts = centernet_loss(out, tgt, cfg)
        return total, (parts, upd["batch_stats"])

    def train_step(params, stats, opt_state, data, step):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
        keys = jax.random.split(key, cfg.batch_size)
        imgs, boxes, cls = jax.vmap(partial(
            _sample_crop, frames=data["frames"], boxes=data["boxes"],
            cls=data["cls"], pos=data["pos"], min_zoom=cfg.min_zoom,
            max_zoom=cfg.max_zoom, pos_fraction=cfg.pos_fraction))(keys)
        (loss, (parts, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, stats, imgs, boxes, cls)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, stats, opt_state, {"loss": loss, **parts}

    return train_step


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def make_optimizer(cfg: TrainConfig):
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, cfg.warmup_steps, cfg.steps, cfg.lr * 0.02)
    return optax.adamw(schedule, weight_decay=cfg.weight_decay)


def train(data: dict, model_cfg: CNNDetectorConfig | None = None,
          cfg: TrainConfig | None = None, log_every: int = 200,
          log_fn=print):
    """Full training run; data from build_dataset (numpy, moved once).

    Trains the BatchNorm twin and returns the FOLDED inference parameters,
    so callers (save/CNNDetector) see the inference parameter tree.
    """
    model_cfg = model_cfg or CNNDetectorConfig()
    cfg = cfg or TrainConfig()
    ddata = jax.device_put({k: jnp.asarray(v) for k, v in data.items()})
    metrics = {}
    model = SignCenterNetV3Train(model_cfg)
    variables = model.init(jax.random.PRNGKey(cfg.seed),
                           jnp.zeros((1, CROP, CROP, 3), jnp.uint8))
    params, stats = variables["params"], variables["batch_stats"]
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    step_fn = jax.jit(make_v3_train_step(model_cfg, cfg),
                      donate_argnums=(0, 1, 2))
    for step in range(cfg.steps):
        params, stats, opt_state, metrics = step_fn(
            params, stats, opt_state, ddata, jnp.int32(step))
        if log_every and (step % log_every == 0 or step == cfg.steps - 1):
            log_fn(f"step {step}: " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()))
    return fold_v3_batchnorm(params, stats), metrics
