"""Distributed training: one SPMD step over a data mesh.

The framework's "training" is closed-form (mean-mask blends, LDA fits) — so
the distributed formulation is sufficient-statistics + collectives rather
than gradient all-reduce:

* every device runs the full proposal pipeline on its shard of the frame
  batch (MSER -> crops -> HOG features), assigns labels from its shard's GT
  boxes by IoU (positives keep the GT super-type, low-IoU proposals are
  background — the reference's negative-mining rule);
* per-class sufficient statistics (counts, feature sums, per-class second
  moments) are ``psum``-reduced over the device mesh;
* every device solves the same small (324-dim) Gaussian-LDA system from the
  reduced statistics — the replicated closed-form "optimizer step".

This replaces the reference's single-threaded in-RAM training
(`Reconocimiento de Objetos/source.py:434-470,551-562`) with a genuinely
multi-chip program; tests exercise it on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from jax.sharding import NamedSharding

from ..config import MSERConfig
from ..constants import NEGATIVE_IOU_MAX
from ..models.lda import LDAParams
from ..ops.color import bgr_to_gray
from ..ops.geometry import filter_and_grow_boxes, iou_matrix
from ..ops.hog import hog_descriptors
from ..ops.mser import mser_regions
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from .mesh import DATA_AXIS

# parity-path float products: full f32, never TF32 (exactness vs the
# float64 reference / CPU backend is what these stages are checked on)
_HI = jax.lax.Precision.HIGHEST

N_CLASSES = 7


def _class_statistics(feats, labels, weights, n_classes: int = N_CLASSES):
    """Per-class sufficient stats: counts [C], sums [C,D], sq [C,D,D]."""
    onehot = (labels[:, None] == jnp.arange(n_classes)[None, :]).astype(
        feats.dtype
    ) * weights[:, None]
    counts = jnp.sum(onehot, axis=0)
    sums = jnp.matmul(onehot.T, feats, precision=_HI)
    sq = jnp.einsum("nc,nd,ne->cde", onehot, feats, feats, precision=_HI)
    return counts, sums, sq


def lda_from_statistics(counts, sums, sq, eps: float = 1e-6):
    """Closed-form Gaussian LDA from psum-reduced statistics.

    Returns (coef [C,D], intercept [C]).  Pooled within-class covariance
    with the (n - C) normalization; ridge eps keeps the solve well-posed on
    degenerate shards.
    """
    n = jnp.sum(counts)
    c, d = sums.shape
    safe = jnp.maximum(counts, 1.0)
    means = sums / safe[:, None]
    sw = jnp.sum(sq, axis=0) - jnp.einsum("c,cd,ce->de", counts, means,
                                          means, precision=_HI)
    cov = sw / jnp.maximum(n - c, 1.0) + eps * jnp.eye(d, dtype=sums.dtype)
    icov_means = jnp.linalg.solve(cov, means.T).T  # [C, D]
    priors = jnp.maximum(counts, 1e-6) / jnp.maximum(n, 1.0)
    intercept = (
        -0.5 * jnp.sum(means * icov_means, axis=1) + jnp.log(priors)
    )
    return icov_means, intercept


def _propose_and_label(frame, gt_boxes, gt_types, cfg: MSERConfig, grow: float,
                       crop: int):
    """One frame -> (features [N,D], labels [N], weights [N])."""
    gray = enhance_contrast(frame)
    props, pvalid = mser_regions(gray, cfg)
    boxes, keep = filter_and_grow_boxes(props, pvalid, grow)
    crops = bgr_to_gray(crop_and_resize(frame, boxes, crop))
    feats = hog_descriptors(crops)

    gt_valid = gt_types > 0
    ious = iou_matrix(boxes, gt_boxes)  # [N, G]
    ious = jnp.where(gt_valid[None, :], ious, -1.0)
    best = jnp.argmax(ious, axis=1)
    best_iou = jnp.max(ious, axis=1)
    labels = jnp.where(
        best_iou > NEGATIVE_IOU_MAX, gt_types[best], 0
    ).astype(jnp.int32)
    return feats, labels, keep.astype(feats.dtype)


def distributed_train_step(mesh: Mesh, cfg: MSERConfig, grow: float = 1.15,
                           crop: int = 32):
    """Build the jitted SPMD train step over ``mesh``.

    Returned fn: (frames [B,H,W,3], gt_boxes [B,G,4], gt_types [B,G])
    -> (coef [7,D], intercept [7], class_counts [7]); inputs sharded on
    batch, outputs replicated.
    """

    def step(frames, gt_boxes, gt_types):
        feats, labels, weights = jax.vmap(
            lambda f, b, t: _propose_and_label(f, b, t, cfg, grow, crop)
        )(frames, gt_boxes, gt_types)
        d = feats.shape[-1]
        feats = feats.reshape(-1, d)
        labels = labels.reshape(-1)
        weights = weights.reshape(-1)
        counts, sums, sq = _class_statistics(feats, labels, weights)
        counts = jax.lax.psum(counts, DATA_AXIS)
        sums = jax.lax.psum(sums, DATA_AXIS)
        sq = jax.lax.psum(sq, DATA_AXIS)
        coef, intercept = lda_from_statistics(counts, sums, sq)
        return coef, intercept, counts

    spec_b = P(DATA_AXIS)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(spec_b, spec_b, spec_b),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(mapped)


def distributed_lda_fit(mesh: Mesh, n_classes: int = N_CLASSES):
    """Sharded-features LDA fit: (X [N,D], y [N], w [N]) -> (coef, intercept).

    The feature matrix is sharded along N; statistics psum over the mesh.
    """

    def fit(X, y, w):
        counts, sums, sq = _class_statistics(X, y, w, n_classes)
        counts = jax.lax.psum(counts, DATA_AXIS)
        sums = jax.lax.psum(sums, DATA_AXIS)
        sq = jax.lax.psum(sq, DATA_AXIS)
        return lda_from_statistics(counts, sums, sq)

    mapped = shard_map(
        fit,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def _pad_to_multiple(arrs, weights, k: int):
    """Pad N-leading arrays (+ weights with 0) so N % k == 0."""
    import numpy as np

    n = len(weights)
    pad = (-n) % k
    if pad == 0:
        return arrs, weights
    out = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
           for a in arrs]
    w = np.concatenate([weights, np.zeros(pad, weights.dtype)])
    return out, w


def fit_classifier_distributed(features_by_class, config, mesh: Mesh):
    """SPMD product-path classifier fit (LDABAYES heads) over ``mesh``.

    Same training-set semantics as `models.recognizer.fit_classifier`
    (`Reconocimiento de Objetos/source.py:551-562`: per type, positives
    mixed with ALL mined negatives, binary labels), but each head is fit
    from psum-reduced per-class sufficient statistics with the descriptor
    matrix sharded across the data mesh — the distributed formulation of
    the reference's in-RAM `LDA.fit`.  Head parity vs the svd-solver
    `lda_fit` is asserted in tests/test_parallel.py (>= 99 % predicted
    label agreement on real HOG descriptors).

    Head LDAParams carry zero ``xbar``/``scalings``: heads only ever run
    `lda_decision`/`lda_predict_proba` (affine coef/intercept maps), never
    `lda_transform`.  The KNN path's reducer needs the transform and keeps
    the host svd fit (`models/lda.py:62`).
    """
    import numpy as np

    from ..models.recognizer import SignClassifier, fit_classifier

    if config.classifier != "LDABAYES":
        return fit_classifier(features_by_class, config)

    k = mesh.devices.size
    fit = distributed_lda_fit(mesh, n_classes=2)
    bs = NamedSharding(mesh, P(DATA_AXIS))
    negatives = features_by_class[0]
    d = negatives.shape[1] if len(negatives) else 324
    heads: list = []
    for t in range(1, 7):
        pos = features_by_class[t]
        if len(pos) == 0:
            heads.append(None)
            continue
        X = np.concatenate([negatives, pos]).astype(np.float32)
        y = np.concatenate(
            [np.zeros(len(negatives), np.int32), np.ones(len(pos), np.int32)]
        )
        w = np.ones(len(y), np.float32)
        (X, y), w = _pad_to_multiple([X, y], w, k)
        coef, intercept = fit(
            jax.device_put(X, bs), jax.device_put(y, bs), jax.device_put(w, bs)
        )
        heads.append(
            LDAParams(
                classes=np.array([0, t]),
                xbar=np.zeros(d, np.float32),
                scalings=np.zeros((d, 1), np.float32),
                coef=np.asarray(coef, np.float32),
                intercept=np.asarray(intercept, np.float32),
            )
        )
    return SignClassifier(config=config, heads=heads)
