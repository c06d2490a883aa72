"""Fused recognition inference: MSER proposals -> HOG -> LDA heads on device.

The reference ships this path commented out (`Reconocimiento de
Objetos/main.py:64`): run the trained classifier over a test directory and
emit resultado.txt detections.  Here it's a first-class batched pipeline:
per frame, proposals (REC variant: grow 1.15, 32x32 crops) are HOG-described
and pushed through the six binary LDA heads (stacked into one [6, 2, D]
tensor contraction) with the reference's arbitration rule — everything
under one jit per batch.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..constants import (
    DEDUP_COORD_TOL,
    DEDUP_HIST_TOL,
    RECOG_CROP,
    RECOG_GROW,
)
from ..data.gt import GroundTruthBox
from ..data.images import list_frame_files, load_image_bgr
from ..data.prefetch import batched_frames
from ..ops.color import bgr_to_gray
from ..ops.dedup import dedup_by_coords, dedup_by_histogram
from ..ops.geometry import filter_and_grow_boxes
from ..ops.hog import gray_descriptors, hog_descriptors
from ..ops.mser import mser_regions
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from .recognizer import SignClassifier, arbitrate_lda_heads

# parity-path float products: full f32, never TF32 (exactness vs the
# float64 reference / CPU backend is what these stages are checked on)
_HI = jax.lax.Precision.HIGHEST


def _stack_heads(clf: SignClassifier) -> tuple[np.ndarray, np.ndarray]:
    """Six binary LDA heads -> (coefs [6, 2, D], intercepts [6, 2])."""
    coefs = np.stack([h.coef for h in clf.heads]).astype(np.float32)
    ints = np.stack([h.intercept for h in clf.heads]).astype(np.float32)
    return coefs, ints


def classify_crops_knn(
    feats: jnp.ndarray,
    xbar: jnp.ndarray,
    scalings: jnp.ndarray,
    train_x: jnp.ndarray,
    train_y: jnp.ndarray,
    classes: jnp.ndarray,
    k: int,
):
    """KNN path on device: LDA-reduce then k-NN majority vote.

    Returns (labels [N], confidence [N] = vote fraction of the winner).
    """
    reduced = jnp.matmul(feats - xbar, scalings, precision=_HI)
    d2 = (
        jnp.sum(reduced * reduced, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(reduced, train_x.T, precision=_HI)
        + jnp.sum(train_x * train_x, axis=1)[None, :]
    )
    _, nn_idx = jax.lax.top_k(-d2, k)
    nn_labels = train_y[nn_idx]
    votes = jnp.sum(nn_labels[..., None] == classes[None, None, :], axis=1)
    best = jnp.argmax(votes, axis=-1)
    conf = jnp.max(votes, axis=-1).astype(jnp.float32) / k
    return classes[best].astype(jnp.int32), conf


def classify_crops_lda(
    feats: jnp.ndarray,
    head_coefs: jnp.ndarray,
    head_ints: jnp.ndarray,
    tol: float,
    sign_margin: float = 0.0,
):
    """[N, D] features -> (labels [N] 0..6, confidence [N]).

    One einsum evaluates all six heads; per-head probabilities are the
    binary-LDA sigmoid of the class-score contrast, then the reference
    arbitration picks the winner.
    """
    scores = (jnp.einsum("nd,hcd->hnc", feats, head_coefs, precision=_HI)
              + head_ints[:, None, :])
    p1 = jax.nn.sigmoid(scores[..., 1] - scores[..., 0])  # [6, N]
    probs = jnp.stack([1.0 - p1, p1], axis=-1)  # [6, N, 2]
    labels = arbitrate_lda_heads(probs, tol, sign_margin)
    conf = jnp.max(jnp.maximum(probs[..., 0], probs[..., 1]), axis=0)
    sign_conf = jnp.max(jnp.where(p1 >= 0.5 - sign_margin, p1, 0.0), axis=0)
    conf = jnp.where(labels > 0, sign_conf, conf)
    return labels, conf


def recognize_frame(bgr: jnp.ndarray, clf_arrays, cfg: PipelineConfig,
                    features: str, clf_kind: str = "LDABAYES", knn_k: int = 4):
    """One frame -> (boxes [D,4] xyxy, labels [D], scores [D], valid [D])."""
    gray = enhance_contrast(bgr)
    props, pvalid = mser_regions(gray, cfg.mser)
    grows = cfg.rec_grows or (RECOG_GROW,)
    per_grow = [filter_and_grow_boxes(props, pvalid, g) for g in grows]
    boxes = jnp.concatenate([b for b, _ in per_grow])
    keep = jnp.concatenate([k for _, k in per_grow])
    crops = crop_and_resize(bgr, boxes, RECOG_CROP)
    crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
    crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
    gray_crops = bgr_to_gray(crops)
    feats = hog_descriptors(gray_crops) if features == "HOG" else gray_descriptors(gray_crops)
    if clf_kind == "LDABAYES":
        head_coefs, head_ints = clf_arrays
        labels, conf = classify_crops_lda(feats, head_coefs, head_ints,
                                          cfg.no_sign_tol, cfg.sign_margin)
    else:
        xbar, scalings, tx, ty, classes = clf_arrays
        labels, conf = classify_crops_knn(feats, xbar, scalings, tx, ty,
                                          classes, knn_k)
    final = keep & (labels > 0)

    d = cfg.max_detections
    n = final.shape[0]
    (idx,) = jnp.nonzero(final, size=d, fill_value=n)
    count = jnp.sum(final)
    valid = jnp.arange(d) < count
    pad = lambda x, fill: jnp.concatenate(
        [x, jnp.full((1,) + x.shape[1:], fill, x.dtype)]
    )
    return (
        pad(boxes, 0)[idx],
        pad(labels, 0)[idx],
        pad(conf, 0.0)[idx],
        valid,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "features", "clf_kind", "knn_k")
)
def recognize_batch(frames, clf_arrays, cfg: PipelineConfig, features: str,
                    clf_kind: str, knn_k: int = 4):
    return jax.vmap(
        lambda f: recognize_frame(f, clf_arrays, cfg, features, clf_kind, knn_k)
    )(frames)


# ---------------------------------------------------------------------------
# CNN-proposal variant (round 4): the flagship detector's low-threshold
# boxes replace the MSER proposal stage.  MSER's proposal-recall ceiling is
# the measured recognition-recall limiter (0.62-0.67 coverage,
# scripts/proposal_recall.py — round-3 diagnosis); the CNN's boxes cover
# 0.75-0.80 of GT at threshold 0.1, so the same trained HOG->LDA/KNN
# classifier reaches the instructor-golden recall regime when fed from it.
# The classifier pipeline itself (crop geometry, descriptors, heads,
# arbitration) is unchanged — this swaps only the proposal source, the
# same substitution the reference structure allows at
# `Reconocimiento de Objetos/source.py:41-64` (its detector is a module
# boundary).
# ---------------------------------------------------------------------------


def grow_boxes_xyxy(boxes, valid, grow: float, frame_hw):
    """Float xyxy boxes -> grown (about center), clipped int32 xyxy.

    The REC-variant geometry contract (grow 1.15,
    `Reconocimiento de Objetos/source.py:54`) applied to detector-space
    float boxes; half-open ints for `crop_and_resize`.
    """
    h, w = frame_hw
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    bw = (x2 - x1) * grow
    bh = (y2 - y1) * grow
    nx1 = jnp.clip(cx - bw * 0.5, 0.0, w - 2.0)
    ny1 = jnp.clip(cy - bh * 0.5, 0.0, h - 2.0)
    nx2 = jnp.clip(cx + bw * 0.5, nx1 + 1.0, float(w))
    ny2 = jnp.clip(cy + bh * 0.5, ny1 + 1.0, float(h))
    out = jnp.stack([nx1, ny1, nx2, ny2], axis=-1).astype(jnp.int32)
    keep = valid & ((x2 - x1) >= 2) & ((y2 - y1) >= 2)
    return out, keep


@functools.partial(
    jax.jit,
    static_argnames=("cnn_cfg", "cfg", "features", "clf_kind", "knn_k"),
)
def recognize_batch_cnn(frames, cnn_params, clf_arrays, cnn_cfg,
                        cfg: PipelineConfig, features: str, clf_kind: str,
                        knn_k: int = 4):
    """CNN proposals -> grown 32x32 crops -> descriptors -> classifier.

    One jit: the detector forward + decode and the whole classification
    stack fuse into a single device program per batch.
    """
    from .cnn_detector import decode_detections, forward

    out = forward(cnn_params, frames, cnn_cfg.compute_dtype())
    pboxes, _, _, pvalid = decode_detections(
        out, cnn_cfg.max_detections, cnn_cfg.score_threshold, cnn_cfg.stride)
    hw = (frames.shape[1], frames.shape[2])
    grow = (cfg.rec_grows or (RECOG_GROW,))[0]

    def per_frame(bgr, bxs, pv):
        boxes, keep = grow_boxes_xyxy(bxs, pv, grow, hw)
        crops = crop_and_resize(bgr, boxes, RECOG_CROP)
        gray_crops = bgr_to_gray(crops)
        feats = (hog_descriptors(gray_crops) if features == "HOG"
                 else gray_descriptors(gray_crops))
        if clf_kind == "LDABAYES":
            head_coefs, head_ints = clf_arrays
            labels, conf = classify_crops_lda(
                feats, head_coefs, head_ints, cfg.no_sign_tol,
                cfg.sign_margin)
        else:
            xbar, scalings, tx, ty, classes = clf_arrays
            labels, conf = classify_crops_knn(
                feats, xbar, scalings, tx, ty, classes, knn_k)
        final = keep & (labels > 0)
        d = cfg.max_detections
        n = final.shape[0]
        (idx,) = jnp.nonzero(final, size=d, fill_value=n)
        valid = jnp.arange(d) < jnp.sum(final)
        pad = lambda x, fill: jnp.concatenate(
            [x, jnp.full((1,) + x.shape[1:], fill, x.dtype)])
        return (pad(boxes, 0)[idx], pad(labels, 0)[idx],
                pad(conf, 0.0)[idx], valid)

    return jax.vmap(per_frame)(frames, pboxes, pvalid)


@dataclasses.dataclass
class RecognitionPipeline:
    """Host-facing recognizer over directories of frames (both classifier
    families run fused on device).

    ``cnn`` (a ``CNNDetector``) switches the proposal source from the MSER
    sweep to the flagship detector's low-threshold boxes (set the detector's
    ``score_threshold`` accordingly); the classifier stack is identical.
    """

    cfg: PipelineConfig
    classifier: SignClassifier
    cnn: object | None = None

    def __post_init__(self):
        if self.classifier.config.classifier == "LDABAYES":
            self._kind = "LDABAYES"
            coefs, ints = _stack_heads(self.classifier)
            self._arrays = (jnp.asarray(coefs), jnp.asarray(ints))
        else:
            self._kind = "KNN"
            red = self.classifier.reducer
            knn = self.classifier.knn
            self._arrays = (
                jnp.asarray(red.xbar.astype(np.float32)),
                jnp.asarray(red.scalings.astype(np.float32)),
                jnp.asarray(knn.train_x.astype(np.float32)),
                jnp.asarray(knn.train_y.astype(np.int32)),
                jnp.asarray(knn.classes.astype(np.int32)),
            )

    def recognize_frames(self, frames: np.ndarray, names: list[str]):
        if self.cnn is not None:
            boxes, labels, scores, valid = recognize_batch_cnn(
                jnp.asarray(frames),
                self.cnn.params,
                self._arrays,
                self.cnn.cfg,
                self.cfg,
                self.classifier.config.features,
                self._kind,
                self.classifier.config.knn_neighbors,
            )
        else:
            boxes, labels, scores, valid = recognize_batch(
                jnp.asarray(frames),
                self._arrays,
                self.cfg,
                self.classifier.config.features,
                self._kind,
                self.classifier.config.knn_neighbors,
            )
        boxes = np.asarray(boxes)
        labels = np.asarray(labels)
        scores = np.asarray(scores)
        valid = np.asarray(valid)
        out: list[GroundTruthBox] = []
        for b in range(frames.shape[0]):
            for i in np.nonzero(valid[b])[0]:
                x1, y1, x2, y2 = (int(v) for v in boxes[b, i])
                out.append(
                    GroundTruthBox(
                        filename=names[b], x1=x1, y1=y1, x2=x2, y2=y2,
                        class_id=int(labels[b, i]), score=float(scores[b, i]),
                    )
                )
        return out

    def run_directory(self, directory: str, progress: bool = False):
        files = list_frame_files(directory)
        bsz = self.cfg.batch_size
        detections: list[GroundTruthBox] = []
        done = 0
        # decode-ahead: the next batch is assembled on a background thread
        # while the device processes the current one
        for frames, names in batched_frames(directory, files, bsz):
            dets = self.recognize_frames(frames, names)
            detections.extend(d for d in dets if d.filename != "__pad__")
            done = min(done + bsz, len(files))
            if progress:
                print(f"  processed {done}/{len(files)} frames")
        return detections
