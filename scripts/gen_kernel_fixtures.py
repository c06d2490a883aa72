#!/usr/bin/env python3
"""Record the outputs of the retired Pallas kernels and of the flax v3 model.

Writes two fixtures that pin the plain-JAX implementations which replaced
them:

* ``tests/fixtures/kernel_fixtures.npz`` -- the fused MSER level sweep
  (full per-level byte maps and the level-collapsed packed map, single- and
  multi-strip), the roll-propagation kernel, the flood+bbox refinement
  kernel and the CLAHE tile-histogram and LUT-apply kernels, all run through
  the Pallas interpreter on seeded inputs;
* ``tests/fixtures/cnn_v3_heads.npz`` -- head maps and decoded detections
  of the flax ``SignCenterNet`` v3 module with the shipped weights
  (``artifacts/cnn_detector/params.npz``) on seeded frames.

It needs the modules it reads (``ops/mser_pallas.py``, ``ops/pallas_prop.py``,
``ops/clahe_pallas.py`` and the flax model classes), so it only runs on a
checkout that still has them: git commit b49999e or earlier, where the
package directory had its earlier name.  Copy this file there and run
``JAX_PLATFORMS=cpu python scripts/gen_kernel_fixtures.py --package
<that directory's name>``.  The tests import only the input builders
(``sweep_cases``, ``sweep_setup``, ``flood_cases``) from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

FIX = os.path.join(ROOT, "tests", "fixtures")
KERNELS = os.path.join(FIX, "kernel_fixtures.npz")
CNN = os.path.join(FIX, "cnn_v3_heads.npz")
PACKAGE = "traffic_sign_detector"


def _mod(name: str):
    """A module of the package under test (``--package`` picks its name)."""
    return importlib.import_module(f"{PACKAGE}.{name}")


# --- inputs shared with the tests (tests/test_ops_mser.py and friends) ---


def two_rects() -> np.ndarray:
    g = np.full((126, 158), 200, np.uint8)
    g[40:60, 50:70] = 30
    g[80:100, 100:124] = 90
    return g


def square_and_rect() -> np.ndarray:
    g = np.full((126, 158), 200, np.uint8)
    g[40:60, 50:70] = 30
    g[80:100, 100:120] = 90
    return g


def three_strips() -> np.ndarray:
    g = np.full((256, 80), 200, np.uint8)
    g[20:44, 30:54] = 30
    g[120:144, 20:44] = 60
    g[210:234, 40:64] = 90
    return g


def seeded_scene(seed: int, h: int, w: int) -> np.ndarray:
    """Noisy background with planted dark and bright blobs, discs, rings."""
    rng = np.random.default_rng(seed)
    g = rng.normal(150, 12, (h, w)).clip(0, 255)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(6):
        cy, cx = rng.integers(12, h - 12), rng.integers(12, w - 12)
        r = rng.integers(5, 12)
        val = rng.choice([25, 60, 230])
        d = np.hypot(yy - cy, xx - cx)
        if rng.random() < 0.3:
            g[(d <= r) & (d >= r - 3)] = val
        else:
            g[d <= r] = val
    return g.astype(np.uint8)


SWEEP_BASE = dict(min_area=60, max_area=1200, max_variation=1.0,
                  level_step=5, ccl_iters=16, ccl_jumps=0, max_regions=32)


def sweep_cases():
    """name -> (gray frame, MSERConfig) for the sweep fixtures."""
    MSERConfig = _mod("config").MSERConfig
    scene_cfg = MSERConfig(delta=7, min_area=30, max_area=600,
                           max_variation=1.0, ccl_iters=8, ccl_jumps=0,
                           max_regions=64, topk_pool=4)
    return {
        "rects": (two_rects(), MSERConfig(topk_pool=4, **SWEEP_BASE)),
        "rects_nodiv": (two_rects(),
                        MSERConfig(min_diversity=0.0, **SWEEP_BASE)),
        "sqrect": (square_and_rect(), MSERConfig(**SWEEP_BASE)),
        "sqrect_ext": (square_and_rect(),
                       MSERConfig(sweep_extent_only=True, **SWEEP_BASE)),
        "strips": (three_strips(), MSERConfig(topk_pool=4, **SWEEP_BASE)),
        "scene": (seeded_scene(5, 94, 126), scene_cfg),
        "scene_scan": (seeded_scene(5, 94, 126),
                       dataclasses.replace(scene_cfg, scan_passes=2)),
        "scene_ext": (seeded_scene(6, 70, 150),
                      dataclasses.replace(scene_cfg, sweep_extent_only=True,
                                          level_step=9, ccl_iters=2)),
    }


def sweep_setup(g, cfg):
    import jax.numpy as jnp

    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    levels = list(range(0, 256 + (d_idx + 1) * s + 1, s))
    gq = jnp.asarray(g).astype(jnp.int32)
    im2 = jnp.pad(jnp.stack([gq, 255 - gq]), ((0, 0), (1, 1), (1, 1)),
                  constant_values=255)
    return im2, levels, d_idx


def flood_cases():
    """name -> (seed maps [N, H, W] i32, masks bool, big, passes)."""
    cases = {}
    h = w = 64
    mask = np.zeros((4, h, w), bool)
    mask[0, 10:30, 10:30] = True
    mask[0, 30:50, 10:16] = True
    mask[1, 8:40, 8:40] = True
    mask[1, 14:34, 14:34] = False
    mask[2, 5:9, 50:60] = True
    big = h * w + 1
    seeds = np.full((4, h, w), big, np.int32)
    for p, (sy, sx) in enumerate([(12, 12), (8, 8), (6, 51), (20, 20)]):
        seeds[p, sy, sx] = 0
    cases["shapes64"] = (seeds, mask, big, 3)

    # sign-scale windows at the refine geometry: thresholded seeded scenes
    rng = np.random.default_rng(21)
    n, h = 8, 128
    masks = np.zeros((n, h, h), bool)
    seeds = np.full((n, h, h), h * h + 1, np.int32)
    for i in range(n):
        g = seeded_scene(100 + i, h, h)
        masks[i] = g <= rng.integers(40, 200)
        masks[i, 0, :] = masks[i, -1, :] = False
        masks[i, :, 0] = masks[i, :, -1] = False
        ys, xs = np.nonzero(masks[i])
        if len(ys) and i != n - 1:  # the last window's seed is off-mask
            j = rng.integers(len(ys))
            seeds[i, ys[j], xs[j]] = 0
        else:
            seeds[i, 64, 64] = 0
            masks[i, 64, 64] = False
    cases["scenes128"] = (seeds, masks, h * h + 1, 2)
    return cases


def gen_kernels(out: dict) -> None:
    import jax.numpy as jnp

    MP = _mod("ops.mser_pallas")
    PP = _mod("ops.pallas_prop")
    CL = _mod("ops.clahe")
    CP = _mod("ops.clahe_pallas")

    for name, (g, cfg) in sweep_cases().items():
        im2, levels, d_idx = sweep_setup(g, cfg)
        out[f"sweep_{name}_gray"] = g
        out[f"sweep_{name}_full"] = np.asarray(MP.fused_level_sweep_full(
            im2, cfg, d_idx, len(levels), interpret=True))
        out[f"sweep_{name}_packed"] = np.asarray(MP.fused_level_sweep(
            im2, cfg, d_idx, len(levels), interpret=True))
        print(name, out[f"sweep_{name}_packed"].shape,
              int((out[f"sweep_{name}_full"] > 0).sum()), "candidates")

    # the same strip frame through the strip-tiled plan (shrunken budget)
    g, cfg = sweep_cases()["strips"]
    im2, levels, d_idx = sweep_setup(g, cfg)
    saved = (MP._VMEM_PX, MP._HALO_MIN, MP._HALO_MAX)
    MP._VMEM_PX, MP._HALO_MIN, MP._HALO_MAX = 160 * 88, 24, 24
    MP.fused_level_sweep.clear_cache()
    plan = MP.sweep_plan(im2.shape[1], im2.shape[2], cfg.topk_pool,
                         MP.plan_halo(cfg))
    out["sweep_strips_tiled_packed"] = np.asarray(MP.fused_level_sweep(
        im2, cfg, d_idx, len(levels), interpret=True))
    MP._VMEM_PX, MP._HALO_MIN, MP._HALO_MAX = saved
    MP.fused_level_sweep.clear_cache()
    print("tiled plan", plan)

    # whole proposal path at the detection CLI's operating point (fused
    # sweep + pooled top-k + fused flood refine, all interpreted)
    import dataclasses as dc

    MSERConfig = _mod("config").MSERConfig
    mser_regions = _mod("ops.mser").mser_regions
    interpret_off = MP.force_interpret
    MP.force_interpret = lambda: True  # the kernels' own interpreter hook
    cli_cfg = dc.replace(MSERConfig(), downscale=2, ccl_iters=2,
                         level_step=9, ccl_jumps=0, max_regions=128)
    gray = seeded_scene(41, 160, 240)
    boxes, valid = mser_regions(jnp.asarray(gray), cli_cfg)
    MP.force_interpret = interpret_off
    out["mser_cli_gray"] = gray
    out["mser_cli_boxes"] = np.asarray(boxes)
    out["mser_cli_valid"] = np.asarray(valid)
    print("cli proposals", int(np.asarray(valid).sum()))

    # radius-1 roll propagation kernel
    for density in (0.2, 0.5):
        rng = np.random.default_rng(int(density * 10))
        shape = (2, 64, 128)
        keys = rng.integers(0, 2**20, shape).astype(np.int32)
        mask = rng.random(shape) < density
        mask[:, 0, :] = mask[:, -1, :] = mask[:, :, 0] = mask[:, :, -1] = False
        tag = f"rolls_{int(density * 10)}"
        out[f"{tag}_keys"], out[f"{tag}_mask"] = keys, mask
        import functools

        import jax
        from jax.experimental import pallas as pl

        # whole-array blocks, interpreted
        kern = functools.partial(PP._kernel, num_rolls=16, big=2**21)
        out[f"{tag}_out"] = np.asarray(pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
            interpret=True,
        )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8)))

    # flood + bbox refinement kernel
    for name, (seeds, masks, big, passes) in flood_cases().items():
        out[f"flood_{name}_seeds"] = seeds
        out[f"flood_{name}_mask"] = masks
        out[f"flood_{name}_out"] = np.asarray(PP.flood_bbox_pallas(
            jnp.asarray(seeds), jnp.asarray(masks), big, passes,
            interpret=True))[:, :5]

    # CLAHE kernels: tile histograms and the interpolated LUT apply
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 64, 128), np.uint8)
    scene = np.stack([seeded_scene(31, 128, 96), seeded_scene(32, 128, 96)])
    for tag, arr in (("noise", x), ("scene", scene)):
        xj = jnp.asarray(arr)
        hist = CP.tile_histograms_pallas(xj, 8, interpret=True)
        th, tw = arr.shape[1] // 8, arr.shape[2] // 8
        clip = max(int(2.0 * th * tw / 256.0), 1)
        luts = CL._tile_luts(CL._clip_and_redistribute(hist, clip), th * tw)
        out[f"clahe_{tag}_in"] = arr
        out[f"clahe_{tag}_hist"] = np.asarray(hist)
        out[f"clahe_{tag}_out"] = np.asarray(
            CP.clahe_apply_pallas(xj, luts, 8, interpret=True))


def gen_cnn(out: dict) -> None:
    import jax.numpy as jnp

    cd = _mod("models.cnn_detector")
    CNNDetectorConfig, SignCenterNet = cd.CNNDetectorConfig, cd.SignCenterNet
    _detect_jit, init_params, load_params = (cd._detect_jit, cd.init_params,
                                             cd.load_params)

    path = os.path.join(ROOT, "artifacts", "cnn_detector", "params.npz")
    rng = np.random.default_rng(17)
    frames = rng.integers(0, 256, (2, 96, 160, 3), np.uint8)
    frames[:, 30:62, 40:72] = (30, 30, 200)  # a red-ish block
    out["frames"] = frames
    for dtype in ("float32", "bfloat16"):
        cfg = CNNDetectorConfig(arch="v3", dtype=dtype, score_threshold=0.0,
                                max_detections=16)
        params = load_params(path, init_params(cfg))
        heads = SignCenterNet(cfg).apply({"params": params},
                                         jnp.asarray(frames))
        for k, v in heads.items():
            out[f"{dtype}_{k}"] = np.asarray(v)
        dets = _detect_jit(cfg, params, jnp.asarray(frames),
                           cfg.max_detections, cfg.score_threshold)
        for k, v in zip(("boxes", "cls", "scores", "valid"), dets):
            out[f"{dtype}_det_{k}"] = np.asarray(v)


def main() -> None:
    global PACKAGE

    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=PACKAGE,
                    help="import name of the package at the checkout run")
    PACKAGE = ap.parse_args().package
    kern: dict = {}
    gen_kernels(kern)
    np.savez_compressed(KERNELS, **kern)
    cnn: dict = {}
    gen_cnn(cnn)
    np.savez_compressed(CNN, **cnn)
    for p in (KERNELS, CNN):
        print(p, os.path.getsize(p), "bytes")


if __name__ == "__main__":
    main()
