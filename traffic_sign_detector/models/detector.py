"""Práctica-1 detection pipeline: batched, fixed-shape, end-to-end on device.

Per frame (all fused under one jit):

    BGR [H,W,3] -> enhance_contrast -> MSER proposals [N,4]
                -> aspect filter + 1.30 grow -> crops [N,25,25,3]
                -> dedup (histogram pass, coords pass)
                -> mean-mask correlation classify -> compact [D] detections

The host driver only decodes JPEGs, batches frames, and serializes results —
the reference's per-image/per-region Python loops (`Deteción de
Objetos/source.py:95-131,611-853`) become one vmapped program over a frame
batch.
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
    DETECT_CROP,
    DETECT_GROW,
)
from ..data.gt import GroundTruthBox
from ..data.images import list_frame_files, load_image_bgr
from ..data.prefetch import batched_frames
from ..ops.color import bgr_to_gray
from ..ops.dedup import dedup_by_coords, dedup_by_histogram
from ..ops.geometry import filter_and_grow_boxes
from ..ops.mser import mser_regions
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from .mean_masks import MeanMaskTemplates, mask_correlation_classify


def detect_frame(
    bgr: jnp.ndarray,
    red_templates: jnp.ndarray,
    blue_templates: jnp.ndarray,
    cfg: PipelineConfig,
):
    """One frame -> (boxes [D,4] xyxy, types [D], scores [D], valid [D])."""
    gray = enhance_contrast(bgr)
    props, pvalid = mser_regions(gray, cfg.mser)
    boxes, keep = filter_and_grow_boxes(props, pvalid, DETECT_GROW)
    crops = crop_and_resize(bgr, boxes, DETECT_CROP)
    crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
    crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
    types, scores, accept = mask_correlation_classify(
        crops, red_templates, blue_templates, cfg.mask_corr_tol,
        fine_scores=cfg.fine_scores,
    )
    final = keep & accept

    d = cfg.max_detections
    n = final.shape[0]
    (idx,) = jnp.nonzero(final, size=d, fill_value=n)
    count = jnp.sum(final)
    valid = jnp.arange(d) < count
    pad = lambda x, fill: jnp.concatenate([x, jnp.full((1,) + x.shape[1:], fill, x.dtype)])
    out_boxes = pad(boxes, 0)[idx]
    out_types = pad(types, 0)[idx]
    out_scores = pad(scores, 0.0)[idx]
    return out_boxes, out_types, out_scores, valid


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_batch(
    frames: jnp.ndarray,
    red_templates: jnp.ndarray,
    blue_templates: jnp.ndarray,
    cfg: PipelineConfig,
):
    """[B, H, W, 3] -> per-frame padded detections."""
    return jax.vmap(lambda f: detect_frame(f, red_templates, blue_templates, cfg))(
        frames
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _detect_batch_packed(
    frames: jnp.ndarray,
    red_templates: jnp.ndarray,
    blue_templates: jnp.ndarray,
    cfg: PipelineConfig,
):
    """detect_batch with all four outputs packed into one [B, D, 7] f32:
    one device->host transfer per batch instead of four."""
    boxes, types, scores, valid = detect_batch(
        frames, red_templates, blue_templates, cfg
    )
    return jnp.concatenate(
        [
            boxes.astype(jnp.float32),
            types[..., None].astype(jnp.float32),
            scores[..., None].astype(jnp.float32),
            valid[..., None].astype(jnp.float32),
        ],
        axis=-1,
    )


@dataclasses.dataclass
class DetectionPipeline:
    """Host-facing detector: owns the trained templates and the jitted fn.

    With ``mesh`` set (a 1-D data mesh from :func:`..parallel.mesh.
    data_mesh`), each batch is sharded over the mesh's devices and the
    whole per-frame pipeline runs SPMD with zero collectives — the
    multi-chip scale-out path for inference (SURVEY.md §2.5).
    """

    cfg: PipelineConfig
    templates: MeanMaskTemplates
    mesh: object | None = None  # jax.sharding.Mesh for multi-chip inference
    _sharded_fn: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.mesh is not None:
            from ..parallel.mesh import sharded_detect_fn

            n_dev = self.mesh.devices.size
            if self.cfg.batch_size % n_dev:
                raise ValueError(
                    f"batch_size {self.cfg.batch_size} must be divisible by "
                    f"the mesh size {n_dev}"
                )
            cfg = self.cfg
            self._sharded_fn = sharded_detect_fn(
                self.mesh, cfg,
                lambda f, r, b: detect_batch(f, r, b, cfg),
            )

    def dispatch(self, frames: np.ndarray):
        """Enqueue one [B, H, W, 3] batch on the device; returns device arrays.

        Dispatch is asynchronous under JAX, so callers can overlap the next
        batch's decode/transfer with this batch's compute and collect the
        results later (see :meth:`run_directory`).
        """
        red = jnp.asarray(self.templates.red)
        blue = jnp.asarray(self.templates.blue)
        if self._sharded_fn is not None:
            from ..parallel.mesh import shard_batch

            return self._sharded_fn(
                shard_batch(self.mesh, np.asarray(frames)), red, blue
            )
        return _detect_batch_packed(jnp.asarray(frames), red, blue, self.cfg)

    def collect(
        self, out, names: list[str], batch: int
    ) -> list[GroundTruthBox]:
        """Materialize a dispatched batch and unpad into detection records."""
        if isinstance(out, tuple):  # sharded path: four separate arrays
            boxes, types, scores, valid = (np.asarray(o) for o in out)
        else:
            packed = np.asarray(out)  # [B, D, 7] — one D2H transfer
            boxes = packed[..., :4].astype(np.int64)
            types = packed[..., 4].astype(np.int64)
            scores = packed[..., 5]
            valid = packed[..., 6] > 0.5
        dets: list[GroundTruthBox] = []
        for b in range(batch):
            for i in np.nonzero(valid[b])[0]:
                x1, y1, x2, y2 = (int(v) for v in boxes[b, i])
                dets.append(
                    GroundTruthBox(
                        filename=names[b],
                        x1=x1,
                        y1=y1,
                        x2=x2,
                        y2=y2,
                        class_id=int(types[b, i]),
                        score=float(scores[b, i]),
                    )
                )
        return dets

    def detect_frames(
        self, frames: np.ndarray, names: list[str]
    ) -> list[GroundTruthBox]:
        """Run a [B, H, W, 3] uint8 batch; unpad into detection records."""
        return self.collect(self.dispatch(frames), names, frames.shape[0])

    def run_directory(
        self, directory: str, progress: bool = False
    ) -> list[GroundTruthBox]:
        """Detect over every frame in a dataset directory.

        Two overlaps keep the device busy: the next batch is decoded on a
        background thread (`batched_frames`), and one dispatched batch is
        kept in flight so its host-side materialization happens while the
        device already crunches the next one.
        """
        files = list_frame_files(directory)
        bsz = self.cfg.batch_size
        detections: list[GroundTruthBox] = []
        done = 0
        pending: tuple | None = None
        # the sharded path re-shards from host memory, so only pre-upload
        # batches on the single-device path
        for frames, names in batched_frames(
            directory, files, bsz, device_put=self._sharded_fn is None
        ):
            out = self.dispatch(frames)
            if pending is not None:
                dets = self.collect(*pending)
                detections.extend(d for d in dets if d.filename != "__pad__")
                done = min(done + bsz, len(files))
                if progress:
                    print(f"  processed {done}/{len(files)} frames")
            pending = (out, names, frames.shape[0])
        if pending is not None:
            dets = self.collect(*pending)
            detections.extend(d for d in dets if d.filename != "__pad__")
            if progress:
                print(f"  processed {len(files)}/{len(files)} frames")
        return detections
