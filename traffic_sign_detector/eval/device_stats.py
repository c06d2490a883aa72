"""On-device detection statistics with mesh-wide psum reduction.

The host statistics engine (:mod:`.stats`) is the parity-exact scorer; this
module is its device formulation for large-scale runs: per-frame padded
detections and ground truth are scored entirely on device (greedy-equivalent
sigmoid matching per super-type) and per-type counters are reduced over the
data mesh with one psum — the "metric totals ride the collectives" design from the
scaling plan (SURVEY.md §2.5/§5).

Matching semantics mirror the reference's checkIfDetection... rule
(`Deteción de Objetos/source.py:402-450`): a detection is correct iff its
best same-type GT in the frame scores > 0.85 on the corner-sigmoid geometric
mean; a GT counts as detected iff some detection chose it as its best match
above threshold.  (The reference's greedy loop marks GTs "seen" but still
counts re-matches as correct, so correctness per detection is independent —
exactly this vectorized form.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..constants import STATS_MATCH_TOL
from ..ops.geometry import boxes_match_score
from ..parallel.mesh import DATA_AXIS

N_TYPES = 6


def frame_type_counts(
    det_boxes: jnp.ndarray,  # [D, 4] xyxy
    det_types: jnp.ndarray,  # [D] 1..6
    det_valid: jnp.ndarray,  # [D] bool
    gt_boxes: jnp.ndarray,  # [G, 4]
    gt_types: jnp.ndarray,  # [G] 1..6 (0/-1 = unused slot)
):
    """One frame -> (correct, incorrect, missed) per type, each [6] int32."""
    scores = boxes_match_score(det_boxes, gt_boxes)  # [D, G]
    gt_alive = gt_types > 0
    same_type = det_types[:, None] == gt_types[None, :]
    eligible = same_type & gt_alive[None, :] & det_valid[:, None]
    eff = jnp.where(eligible, scores, -jnp.inf)

    best_gt = jnp.argmax(eff, axis=1)  # [D]
    best_score = jnp.max(eff, axis=1)
    det_correct = det_valid & (best_score > STATS_MATCH_TOL)

    # a GT is detected iff it is some correct detection's best match
    chosen = jnp.zeros(gt_boxes.shape[0], bool).at[best_gt].max(det_correct)

    types = jnp.arange(1, N_TYPES + 1)
    det_of_type = det_valid[:, None] & (det_types[:, None] == types[None, :])
    correct = jnp.sum(det_of_type & det_correct[:, None], axis=0)
    incorrect = jnp.sum(det_of_type & ~det_correct[:, None], axis=0)
    gt_of_type = gt_alive[:, None] & (gt_types[:, None] == types[None, :])
    missed = jnp.sum(gt_of_type & ~chosen[:, None], axis=0)
    return correct.astype(jnp.int32), incorrect.astype(jnp.int32), missed.astype(jnp.int32)


def distributed_statistics(mesh: Mesh):
    """Build the jitted mesh-wide scorer.

    fn: (det_boxes [B,D,4], det_types [B,D], det_valid [B,D],
         gt_boxes [B,G,4], gt_types [B,G])  — batch-sharded —
        -> (correct [6], incorrect [6], missed [6]) replicated totals.
    """

    def score(db, dt, dv, gb, gt):
        c, i, m = jax.vmap(frame_type_counts)(db, dt, dv, gb, gt)
        c = jax.lax.psum(jnp.sum(c, axis=0), DATA_AXIS)
        i = jax.lax.psum(jnp.sum(i, axis=0), DATA_AXIS)
        m = jax.lax.psum(jnp.sum(m, axis=0), DATA_AXIS)
        return c, i, m

    spec = P(DATA_AXIS)
    return jax.jit(
        shard_map(
            score,
            mesh=mesh,
            in_specs=(spec,) * 5,
            out_specs=(P(), P(), P()),
        )
    )
