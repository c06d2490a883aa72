"""Duplicate-detection suppression as masked pairwise-matrix reductions.

The reference folds detections one-by-one into a clean list
(`Deteción de Objetos/source.py:177-223`): each incoming item is compared
against every kept item; similarity > tol deletes the kept item (newcomer
wins), similarity in the band [0.8823*tol, tol] merges them (50/50 pixel
blend + integer-mean coords) and deletes the kept item.  Because items are
always appended when processed, an item j survives iff no later item i has
similarity >= 0.8823*tol against it — which turns the sequential fold into a
single upper-triangular matrix reduction, the data-parallel formulation.

Outcome contract vs the reference (validated end-to-end on the dataset):

* survivor set: exact for delete-band chains, approximate only where a merge
  changes an item's coords/pixels enough to flip a later comparison
  (second-order; merges join near-identical items by construction);
* merged coords: arithmetic mean over the merge group instead of the
  reference's order-dependent pairwise fold ((a+b)//2 folded repeatedly);
* merged pixels: mean over the merge group instead of iterated 50/50 blends.

Two passes, same structure: pass 1 keys on HS-histogram correlation of the
crops (tolerance 0.85), pass 2 on corner-distance sigmoid similarity of the
coords (tolerance 0.95).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import DEDUP_MERGE_BAND
from .geometry import pairwise_coord_similarity
from .histogram import hist_correlation

# parity-path float products: full f32, never TF32 (exactness vs the
# float64 reference / CPU backend is what these stages are checked on)
_HI = jax.lax.Precision.HIGHEST


def _dedup_from_sims(
    sims: jnp.ndarray,
    crops: jnp.ndarray,
    boxes: jnp.ndarray,
    valid: jnp.ndarray,
    tol: float,
):
    """Shared core: given [N, N] similarities, apply the fold contract."""
    n = sims.shape[0]
    band_lo = DEDUP_MERGE_BAND * tol

    vv = valid[:, None] & valid[None, :]
    later = jnp.arange(n)[:, None] > jnp.arange(n)[None, :]  # i processed after j

    # j is deleted iff some later valid i relates to it at >= band_lo.
    kill = vv & later & (sims >= band_lo)
    alive = valid & ~jnp.any(kill, axis=0)

    # Merge groups: surviving i absorbs earlier j in the merge band.
    merge = (
        vv
        & later
        & (sims >= band_lo)
        & (sims <= tol)
        & alive[:, None]
    )
    group = merge | (jnp.eye(n, dtype=bool) & alive[:, None])
    counts = jnp.sum(group, axis=1).astype(jnp.float32)  # >= 1 for alive rows
    counts = jnp.maximum(counts, 1.0)

    boxes_f = boxes.astype(jnp.float32)
    new_boxes = jnp.matmul(group.astype(jnp.float32), boxes_f,
                           precision=_HI) / counts[:, None]
    new_boxes = jnp.where(alive[:, None], new_boxes.astype(jnp.int32), boxes)

    crops_f = crops.reshape(n, -1).astype(jnp.float32)
    blended = jnp.matmul(group.astype(jnp.float32), crops_f,
                         precision=_HI) / counts[:, None]
    blended = jnp.rint(blended).astype(crops.dtype).reshape(crops.shape)
    new_crops = jnp.where(
        alive.reshape((n,) + (1,) * (crops.ndim - 1)), blended, crops
    )
    return new_crops, new_boxes, alive


def dedup_by_histogram(
    crops: jnp.ndarray, boxes: jnp.ndarray, valid: jnp.ndarray, tol: float
):
    """Pass 1: appearance dedup via HS-histogram correlation of the crops."""
    sims = hist_correlation(crops)
    return _dedup_from_sims(sims, crops, boxes, valid, tol)


def dedup_by_coords(
    crops: jnp.ndarray, boxes: jnp.ndarray, valid: jnp.ndarray, tol: float
):
    """Pass 2: geometric dedup via corner-sigmoid similarity of the boxes."""
    sims = pairwise_coord_similarity(boxes)
    return _dedup_from_sims(sims, crops, boxes, valid, tol)
