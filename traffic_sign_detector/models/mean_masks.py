"""Recognizer A: per-super-type mean color masks + masked-F1 scoring.

Training (`Deteción de Objetos/source.py:24-59`): for each of the six sign
super-types, all training crops (train_jpg/<class>/<file>.jpg for the type's
GTSRB classes) are resized to 25x25 and folded with a running 50/50 blend —
an *exponential*, not arithmetic, mean (the reference's addWeighted chain;
later crops dominate).  The blended image's red and blue HSV masks become the
type's templates.

Scoring (`Deteción de Objetos/source.py:229-261,545-567`): a detection crop's
red/blue mask is ANDed with each template (the reference does this with a
uint8 multiply whose 255*255 == 1 mod-256 wraparound makes the product an
0/1 indicator — we compute the AND directly) and scored with the pixel F1 of
that intersection against the template.  Since the intersection is a subset
of the template there are no false positives, so F1 = 2TP/(2TP+FN) with
TP = |crop & tmpl|, FN = |tmpl| - TP.  Templates with almost no support in
the crop's colorspace (true negatives within 1% of the whole 625-pixel grid,
i.e. TP+FN <= 6.25) are forced to score 0.  Scores are rounded to 2 decimals
(the reference rounds before comparing to its 0.55 acceptance threshold).

On device the whole scorer is two [N, 625] x [625, 6] matmuls per color.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DETECT_CROP, MASK_CORR_TOL, SUPERTYPE_CLASS_DIRS
from ..data.images import load_image_bgr
from ..ops.color import color_mask
from ..ops.resize import crop_and_resize

_PIX = DETECT_CROP * DETECT_CROP


@dataclasses.dataclass(frozen=True)
class MeanMaskTemplates:
    """Trained templates: red/blue binary masks per super-type, [6, 625]."""

    red: np.ndarray  # float32 {0,1}
    blue: np.ndarray

    def save(self, path: str) -> None:
        np.savez(path, red=self.red, blue=self.blue)

    @classmethod
    def load(cls, path: str) -> "MeanMaskTemplates":
        z = np.load(path)
        return cls(red=z["red"], blue=z["blue"])


def _resize_crops_25(imgs: list[np.ndarray]) -> np.ndarray:
    """Resize variable-size BGR crops to 25x25 in one fixed-shape device call
    (images are zero-padded into a common buffer; the crop box selects the
    real extent, so padding never leaks into the output)."""
    hp = max(1, *(im.shape[0] for im in imgs))
    wp = max(1, *(im.shape[1] for im in imgs))
    hp = -(-hp // 32) * 32  # round up: few distinct shapes -> few compiles
    wp = -(-wp // 32) * 32
    buf = np.zeros((len(imgs), hp, wp, 3), np.uint8)
    boxes = np.zeros((len(imgs), 4), np.int32)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        buf[i, :h, :w] = im
        boxes[i] = (0, 0, w, h)
    fn = jax.vmap(lambda im, bx: crop_and_resize(im, bx[None], DETECT_CROP)[0])
    return np.asarray(fn(jnp.asarray(buf), jnp.asarray(boxes)))


def _blend_fold(crops: np.ndarray) -> np.ndarray:
    """Running 50/50 uint8 blend (first crop taken whole), like the
    reference's addWeighted chain; per-step round-half-even."""
    acc = crops[0].astype(np.float64)
    for c in crops[1:]:
        acc = np.rint(0.5 * acc + 0.5 * c.astype(np.float64))
    return acc.astype(np.uint8)


def train_mean_masks(train_dir: str) -> MeanMaskTemplates:
    """Train the six mean-mask templates from train_jpg/<class>/ crops."""
    reds, blues = [], []
    for class_dirs in SUPERTYPE_CLASS_DIRS:
        raw = []
        for d in class_dirs:
            droot = os.path.join(train_dir, d)
            if not os.path.isdir(droot):
                continue
            for fname in sorted(os.listdir(droot)):
                if not fname.lower().endswith((".jpg", ".jpeg", ".ppm", ".png")):
                    continue
                raw.append(load_image_bgr(os.path.join(droot, fname)))
        if not raw:
            raise FileNotFoundError(
                f"no training crops under {train_dir} for dirs {class_dirs}"
            )
        mean_crop = _blend_fold(_resize_crops_25(raw))
        red = np.asarray(color_mask(jnp.asarray(mean_crop), "r"))
        blue = np.asarray(color_mask(jnp.asarray(mean_crop), "b"))
        reds.append((red.reshape(-1) > 0).astype(np.float32))
        blues.append((blue.reshape(-1) > 0).astype(np.float32))
    return MeanMaskTemplates(red=np.stack(reds), blue=np.stack(blues))


def _score_color(crop_masks: jnp.ndarray, templates: jnp.ndarray):
    """crop_masks [N, 625] {0,1} x templates [6, 625] -> best scores.

    Returns (score [N], type [N] in 1..6, raw [N]): ``score`` is the
    reference's 2-decimal-rounded masked F1 (its threshold compares the
    rounded value), ``raw`` the unrounded F1 of the winning type — a
    tie-free ranking key for the AP protocol (see
    ``mask_correlation_classify(fine_scores=...)``).
    """
    tp = jnp.matmul(crop_masks, templates.T,
                    precision=jax.lax.Precision.HIGHEST)  # [N, 6]
    tmpl_sizes = jnp.sum(templates, axis=-1)  # [6]
    fn = tmpl_sizes[None, :] - tp
    raw = 2.0 * tp / jnp.maximum(2.0 * tp + fn, 1e-9)
    raw = jnp.where(tp + fn <= _PIX * 0.01, 0.0, raw)
    score = jnp.round(raw * 100.0) / 100.0
    best = jnp.argmax(score, axis=-1)
    take = lambda x: jnp.take_along_axis(x, best[:, None], axis=-1)[:, 0]
    return take(score), best.astype(jnp.int32) + 1, take(raw)


def mask_correlation_classify(
    crops_bgr: jnp.ndarray,
    red_templates: jnp.ndarray,
    blue_templates: jnp.ndarray,
    tol: float = MASK_CORR_TOL,
    fine_scores: bool = False,
):
    """Classify 25x25 crops against the trained templates.

    crops_bgr: [N, 25, 25, 3] uint8.
    Returns (types int32 [N] in 1..6, scores float32 [N], accept bool [N]).
    Red wins ties the way the reference's branch does (strictly greater
    scoreRed picks red, otherwise blue).

    ``fine_scores`` (framework knob, default False = parity): every
    accept/type decision stays on the reference's 2-decimal-rounded
    scores, but the *reported* score is the unrounded masked F1 — the AP
    protocol ranks detections by score, and 2-decimal rounding leaves
    ~100 distinct values over hundreds of detections (tie-heavy ranking).
    """
    n = crops_bgr.shape[0]
    red_m = (color_mask(crops_bgr, "r") > 0).reshape(n, -1).astype(jnp.float32)
    blue_m = (color_mask(crops_bgr, "b") > 0).reshape(n, -1).astype(jnp.float32)
    score_r, type_r, raw_r = _score_color(red_m, red_templates)
    score_b, type_b, raw_b = _score_color(blue_m, blue_templates)
    use_red = score_r > score_b
    score = jnp.where(use_red, score_r, score_b)
    sign_type = jnp.where(use_red, type_r, type_b)
    accept = score > tol
    if fine_scores:
        score = jnp.where(use_red, raw_r, raw_b)
    return sign_type, score, accept
