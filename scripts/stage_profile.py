#!/usr/bin/env python3
"""Per-stage device time of the MSER detection pipeline.

    python scripts/stage_profile.py [--batch 32] [--size gtsdb|1080p]

Times each stage of ``detect_frame`` at the detection CLI's operating point
(``main_detection.operating_point``), each stage jitted, warmed and timed
over ``--iters`` calls ending in ``block_until_ready``: the whole batch,
preprocess (gray + CLAHE + blur + gamma), CLAHE alone, the bbox-area level
sweep, the proposal stage (sweep + top-k + refine flood) and the
crop/dedup/classify tail.  Frames are seeded synthetic scenes with planted
signs (``data/synthetic.py``).  Prints the card beside the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timeit(fn, *args, iters: int = 10):
    """(seconds per call, last output): warm once, then time ``iters``."""
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return jax.devices()[0].device_kind


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", choices=["gtsdb", "1080p"], default="gtsdb")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()

    from main_detection import operating_point
    from traffic_sign_detector.config import (
        MSERConfig,
        PipelineConfig,
    )
    from traffic_sign_detector.constants import (
        DEDUP_COORD_TOL,
        DEDUP_HIST_TOL,
        DETECT_CROP,
        DETECT_GROW,
    )
    from traffic_sign_detector.data.synthetic import synth_frames
    from traffic_sign_detector.models.detector import detect_batch
    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
        mask_correlation_classify,
    )
    from traffic_sign_detector.ops.clahe import clahe_equalize
    from traffic_sign_detector.ops.color import bgr_to_gray
    from traffic_sign_detector.ops.dedup import (
        dedup_by_coords,
        dedup_by_histogram,
    )
    from traffic_sign_detector.ops.geometry import (
        filter_and_grow_boxes,
    )
    from traffic_sign_detector.ops.mser import (
        bbox_level_sweep,
        mser_regions_batch,
    )
    from traffic_sign_detector.ops.preprocess import (
        enhance_contrast,
    )
    from traffic_sign_detector.ops.resize import crop_and_resize
    from traffic_sign_detector.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    c = operating_point(MSERConfig.from_string("MSER_7_200_2000_1"))
    cfg = PipelineConfig(mser=c, batch_size=args.batch)
    hw = (1088, 1920) if args.size == "1080p" else (800, 1360)
    frames = jnp.asarray(synth_frames(args.batch, seed=0, hw=hw))
    templates = MeanMaskTemplates.load("artifacts/mean_masks.npz")
    red, blue = jnp.asarray(templates.red), jnp.asarray(templates.blue)
    it = args.iters

    t_total, _ = timeit(
        jax.jit(lambda f: detect_batch(f, red, blue, cfg)), frames, iters=it)
    t_pre, gray = timeit(jax.jit(jax.vmap(enhance_contrast)), frames,
                         iters=it)
    t_clahe, _ = timeit(jax.jit(lambda f: clahe_equalize(bgr_to_gray(f))),
                        frames, iters=it)

    # the sweep alone, on the downsampled 255-bordered polarity stack
    ds = c.downscale
    h0, w0 = gray.shape[1:]
    pool = c.topk_pool

    def sweep_input(g):
        d = (g[:h0 // ds * ds, :w0 // ds * ds]
             .reshape(h0 // ds, ds, w0 // ds, ds).astype(jnp.int32)
             .mean(axis=(1, 3))).astype(jnp.int32)
        im2 = jnp.pad(jnp.stack([d, 255 - d]), ((0, 0), (1, 1), (1, 1)),
                      constant_values=255)
        h, w = im2.shape[1:]
        return jnp.pad(im2, ((0, 0), (0, -h % pool), (0, -w % pool)),
                       constant_values=255)

    s = c.level_step
    d_idx = max(1, round(c.delta / s))
    num_levels = len(range(0, 256 + (d_idx + 1) * s + 1, s))
    sub = dataclasses.replace(c, min_area=max(c.min_area // ds ** 2, 1),
                              max_area=max(c.max_area // ds ** 2, 1),
                              downscale=1)
    im2s = jax.jit(jax.vmap(sweep_input))(gray)
    t_sweep, _ = timeit(jax.jit(jax.vmap(
        lambda im2: bbox_level_sweep(im2, sub, d_idx, num_levels))), im2s,
        iters=it)
    t_mser, (props, pvalid) = timeit(
        jax.jit(lambda g: mser_regions_batch(g, c)), gray, iters=it)

    @jax.jit
    def post(frames, props, pvalid):
        def one(bgr, pr, pv):
            boxes, keep = filter_and_grow_boxes(pr, pv, DETECT_GROW)
            crops = crop_and_resize(bgr, boxes, DETECT_CROP)
            crops, boxes, keep = dedup_by_histogram(crops, boxes, keep,
                                                    DEDUP_HIST_TOL)
            crops, boxes, keep = dedup_by_coords(crops, boxes, keep,
                                                 DEDUP_COORD_TOL)
            types, scores, accept = mask_correlation_classify(
                crops, red, blue, cfg.mask_corr_tol)
            return boxes, types, scores, keep & accept

        return jax.vmap(one)(frames, props, pvalid)

    t_post, _ = timeit(post, frames, props, pvalid, iters=it)

    b = args.batch
    print(f"card: {card()}")
    print(f"batch={b} {args.size} {c.to_string()} downscale={ds} "
          f"step={s} iters={c.ccl_iters} refine_scan={c.refine_scan_passes}")
    print(f"  {'whole pipeline':34s} {t_total * 1e3:9.2f} ms  "
          f"({b / t_total:7.1f} frames/s)")
    for name, t in [
        ("preprocess (gray+CLAHE+blur+gamma)", t_pre),
        ("  of which CLAHE", t_clahe),
        ("bbox-area level sweep", t_sweep),
        ("proposals (sweep+top-k+refine)", t_mser),
        ("  top-k + refine (difference)", t_mser - t_sweep),
        ("crop/dedup/classify", t_post),
    ]:
        print(f"  {name:34s} {t * 1e3:9.2f} ms  {100 * t / t_total:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
