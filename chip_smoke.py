#!/usr/bin/env python3
"""Smoke check of both detection paths and recognition on one GPU.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: the --n_devices paths

Drives the objects the CLIs build (``load_detector``, ``DetectionPipeline``,
``RecognitionPipeline``) on seeded synthetic 1360x800 frames with planted
sign-like shapes in the six super-type colours, with the shipped weights,
mean-mask templates and LDA heads, and compares every result with a plain
reference: an f32 forward at ``Precision.HIGHEST`` for the bf16 CNN, and
the same program on the CPU backend for the integer and parity paths.

Each phase prints its compile (first call) and run (second call) time on
its own line.  Any failed comparison raises, so the script exits non-zero
and prints no result; the last line of a passing run is one JSON object
with the device JAX reports.  Runs in one process: a second JAX process on
the card would find its memory reserved.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from traffic_sign_detector.data.synthetic import (
    synth_frames,
    to_patches8,
    to_yuv420,
)
from traffic_sign_detector.utils.compile_cache import (
    CHECKOUT,
    enable_compile_cache,
)

H, W = 800, 1360                 # GTSDB frame geometry
CNN_BATCH = 128
MSER_BATCH = 32                  # the detection CLI's default batch
PARAMS = f"{CHECKOUT}/artifacts/cnn_detector/params.npz"
PARAMS_INT8 = f"{CHECKOUT}/artifacts/cnn_detector/params_int8.npz"
TEMPLATES = f"{CHECKOUT}/artifacts/mean_masks.npz"
CLASSIFIER = f"{CHECKOUT}/artifacts/sign_classifier"

# Tolerances, stated once.  bf16 vs the f32 reference: a bf16 operand and
# every layer's bf16 result keep 8 significant bits, compounded over seven
# layers of K<=1152 sums; the measured worst case over the 3.3M head
# logits of 128 frames is 0.055 * (1 + |ref|) on an H100 (0.015 on 2
# frames on the CPU backend).
BF16_MAP_TOL = 0.1               # |bf16 - ref| <= TOL * (1 + |ref|)
BF16_SCORE_TOL = 0.05            # sigmoid score of a matched peak
# box corners are (cell + offset -/+ size/2) * 16 px, so the size maps'
# tolerance alone allows ~0.4 cell: half a stride cell in px
BF16_BOX_TOL = 8.0               # px, box of a matched peak
CONFIDENT = 0.3                  # a reference peak that must be matched
# int8: accumulators exact; the f32 epilogue (scale, bias, relu, requant)
# may contract to FMA on one backend and not the other, and a requant that
# flips by one step moves a head logit by ~a3_scale * |w|.
INT8_MAP_TOL = 0.05              # |gpu - cpu| absolute, head maps
INT8_SCORE_TOL = 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def timed(fn, *args):
    """(result, compile_s, run_s): first call compiles, second is timed."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, t1 - t0, time.perf_counter() - t1


def phase_time(name: str, compile_s: float, run_s: float) -> None:
    log(f"[{name}] compile {compile_s:.2f} s, run {run_s:.4f} s")


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def compare_maps(got: dict, ref: dict, tol: float, relative: bool,
                 what: str) -> None:
    for key in ("hm", "size", "off"):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        check(g.shape == r.shape and np.isfinite(g).all(),
              f"{what} {key} finite, shape {g.shape}")
        d = np.abs(g - r)
        if relative:
            worst = float((d / (1.0 + np.abs(r))).max())
            check(worst <= tol, f"{what} {key}: max |d|/(1+|ref|) "
                  f"{worst:.4f} <= {tol}")
        else:
            check(float(d.max()) <= tol,
                  f"{what} {key}: max |d| {float(d.max()):.5f} <= {tol}")


def compare_decode(got, ref, score_tol: float, box_tol: float,
                   what: str) -> None:
    """Threshold-free top-k decodes: every confident peak of either side
    (score >= CONFIDENT) has a same-class peak on the other side within one
    grid cell, with its score within ``score_tol`` and its box within
    ``box_tol`` px.  (Peaks are matched by position, not by rank: where
    two neighbouring cells nearly tie, the 3x3 max-pool NMS may keep a
    different one of them on each side.)"""
    g = [np.asarray(a) for a in got]
    r = [np.asarray(a) for a in ref]
    n, worst_s, worst_b = 0, 0.0, 0.0
    for (ab, ac, a_s, _), (bb, bc, b_s, _), side in ((r, g, "ref"),
                                                     (g, r, "got")):
        for i in range(ab.shape[0]):
            for j in np.nonzero(a_s[i] >= CONFIDENT)[0]:
                n += 1
                ctr = (ab[i, j, :2] + ab[i, j, 2:]) / 2
                cand = np.nonzero(
                    (bc[i] == ac[i, j])
                    & (np.abs((bb[i, :, :2] + bb[i, :, 2:]) / 2 - ctr)
                       .max(-1) <= box_tol + 16))[0]
                if not len(cand):
                    raise AssertionError(
                        f"{what}: {side} peak {j} of frame {i} (score "
                        f"{a_s[i, j]:.3f}) has no same-class peak nearby")
                k = cand[np.argmin(np.abs(b_s[i, cand] - a_s[i, j]))]
                ds = abs(float(b_s[i, k] - a_s[i, j]))
                db = float(np.abs(bb[i, k] - ab[i, j]).max())
                if ds > score_tol or db > box_tol:
                    raise AssertionError(
                        f"{what}: {side} peak {j} of frame {i}: score "
                        f"|d| {ds:.4f} (tol {score_tol}), box |d| {db:.2f} "
                        f"px (tol {box_tol})")
                worst_s, worst_b = max(worst_s, ds), max(worst_b, db)
    check(n > 0, f"{what}: {n} confident peaks matched both ways, worst "
          f"score |d| {worst_s:.4f} <= {score_tol}, worst box |d| "
          f"{worst_b:.2f} px <= {box_tol}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from traffic_sign_detector.runtime import loader

    devs = jax.devices()
    check(all(d.platform == "gpu" for d in devs),
          f"{len(devs)} gpu device(s): {devs[0].device_kind}")
    log(f"native JPEG loader builds here: {loader.available()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_cnn_float(frames: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp

    from traffic_sign_detector.models import cnn_detector as cd
    from traffic_sign_detector.models.cnn_quant import (
        load_detector,
    )
    from traffic_sign_detector.ops import upscale as up
    from traffic_sign_detector.ops.yuv import (
        patchify_yuv_planes,
        yuv420_to_bgr,
    )

    det = load_detector(PARAMS)
    cfg = dataclasses.replace(det.cfg, score_threshold=0.0)
    det.cfg = cfg
    k = cfg.max_detections
    names = [f"{i:05d}.ppm" for i in range(len(frames))]
    dev = jnp.asarray(frames)

    fwd = jax.jit(cd.forward, static_argnums=2)
    with jax.default_matmul_precision("highest"):
        ref_maps, c_ref, r_ref = timed(fwd, det.params, dev, jnp.float32)
    phase_time("cnn float: f32 HIGHEST reference forward", c_ref, r_ref)
    ref_dec = cd.decode_detections(ref_maps, k, 0.0, cfg.stride)

    maps, c, r = timed(fwd, det.params, dev, jnp.bfloat16)
    phase_time("cnn float: bf16 forward (head maps)", c, r)
    compare_maps(maps, ref_maps, BF16_MAP_TOL, True, "bf16 vs f32")

    inputs = {
        "bgr": (det.dispatch, (dev,)),
        "patches8": (det.dispatch, (jnp.asarray(to_patches8(frames)),)),
    }
    y, cb, cr = to_yuv420(frames)
    inputs["yuv420p"] = (det.dispatch_yuv, tuple(
        jnp.asarray(p) for p in patchify_yuv_planes(y, cb, cr)))
    for name, (fn, args) in inputs.items():
        out, c, r = timed(fn, *args)
        phase_time(f"cnn float: dispatch {name} batch {len(frames)}", c, r)
        ref = ref_dec
        if name == "yuv420p":
            with jax.default_matmul_precision("highest"):
                bgr = jax.jit(yuv420_to_bgr)(jnp.asarray(y), jnp.asarray(cb),
                                             jnp.asarray(cr))
                ref = cd.decode_detections(
                    fwd(det.params, bgr, jnp.float32), k, 0.0, cfg.stride)
        compare_decode(out, ref, BF16_SCORE_TOL, BF16_BOX_TOL, name)
        dets = det.collect(out, names, (H, W))
        check(len(dets) > 0, f"{name}: collect -> {len(dets)} detections")

    # --upscale 1.6: the fused upscale+stem plan vs an f32 forward on the
    # un-rounded bilinear upscale (the same linear map, unfolded)
    det_up = load_detector(PARAMS, upscale=1.6)
    det_up.cfg = cfg
    plan = det_up._fused_plan(H, W)
    check(plan is not None, f"--upscale 1.6 takes the fused plan "
          f"{plan.t}/{plan.a} -> {plan.h_out}x{plan.w_out}")
    out, c, r = timed(det_up.dispatch, dev)
    phase_time("cnn float: dispatch bgr --upscale 1.6", c, r)

    def ref_up(params, x):
        x = jnp.pad(x, ((0, 0), (0, plan.h_pad - plan.h),
                        (0, plan.w_pad - plan.w), (0, 0)), mode="edge")
        x = up._upscale_axis(x, 1, plan.h_out)
        x = up._upscale_axis(x, 2, plan.w_out)
        boxes, cls, scores, valid = cd.decode_detections(
            cd.forward(params, x, jnp.float32), k, 0.0, cfg.stride)
        return cd.rescale_boxes(boxes, *plan.rescale_factors()), cls, \
            scores, valid

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(ref_up)(det.params, dev)
    compare_decode(out, ref, BF16_SCORE_TOL, BF16_BOX_TOL * 1.6,
                   "upscale 1.6")
    check(len(det_up.collect(out, names, (H, W))) > 0,
          "upscale 1.6: collect -> detections")


def phase_cnn_int8(frames: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp
    from traffic_sign_detector.models import cnn_detector as cd
    from traffic_sign_detector.models import cnn_quant as cq

    qdet = cq.load_detector(PARAMS_INT8)
    check(isinstance(qdet, cq.QuantCNNDetector), "int8 artifact dispatches "
          "to QuantCNNDetector")
    qdet.cfg = dataclasses.replace(qdet.cfg, score_threshold=0.0)
    k = qdet.cfg.max_detections
    cpu = jax.devices("cpu")[0]
    q_cpu = jax.device_put(qdet.q, cpu)
    # s8 x s8 -> s32 products at the real layer shapes on identical int8
    # inputs, as the product chain issues them: must be bit-exact on both
    rng = np.random.default_rng(3)
    hs, ws = H // 8, W // 8
    heads, _ = cq.head_kernel(qdet.q)
    layers = [("q0 stem matmul", None, None, (4, hs, ws, 192)),
              ("q1 conv", qdet.q["q1_kernel"], 2, (4, hs, ws, 64)),
              ("q2 conv", qdet.q["q2_kernel"], 1, (4, hs // 2, ws // 2, 128)),
              ("q3 conv", qdet.q["q3_kernel"], 1, (4, hs // 2, ws // 2, 128)),
              ("q4-6 heads conv", heads, 1, (4, hs // 2, ws // 2, 128))]

    def acc(x, kern, stride):
        if stride is None:
            return jnp.einsum("bhwk,kf->bhwf", x, kern,
                              preferred_element_type=jnp.int32)
        return cq.conv_s8(x, kern, stride)

    f = jax.jit(acc, static_argnums=2)
    for name, kern, stride, shape in layers:
        kern = qdet.q["q0_kernel"] if kern is None else kern
        x = rng.integers(-128 if stride is None else 0, 128, shape,
                         dtype=np.int64).astype(np.int8)
        g = np.asarray(f(jnp.asarray(x), kern, stride))
        c = np.asarray(f(jax.device_put(x, cpu), jax.device_put(kern, cpu),
                         stride))
        check(g.dtype == np.int32 and np.array_equal(g, c),
              f"int8 {name}: int32 accumulators bit-exact vs CPU "
              f"(shape {g.shape})")

    out, c, r = timed(qdet.dispatch, jnp.asarray(frames))
    phase_time(f"cnn int8: dispatch bgr batch {len(frames)}", c, r)
    sub = frames[:8]
    fwd = jax.jit(cq.v3_int8_forward)
    g_maps = fwd(qdet.q, jnp.asarray(sub))
    c_maps, c, r = timed(fwd, q_cpu, jax.device_put(sub, cpu))
    phase_time("cnn int8: same program on the CPU backend, 8 frames", c, r)
    compare_maps(g_maps, c_maps, INT8_MAP_TOL, False, "int8 gpu vs cpu")
    g_dec = [np.asarray(a)[:8] for a in out]
    c_dec = cd.decode_detections(c_maps, k, 0.0, qdet.cfg.stride)
    compare_decode(g_dec, c_dec, INT8_SCORE_TOL, 1.0, "int8 decode")
    out_p, c, r = timed(qdet.dispatch, jnp.asarray(to_patches8(frames)))
    phase_time("cnn int8: dispatch patches8", c, r)
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in zip(out_p, out)), "int8 patches8 == bgr exactly")


def _proposals_fn(cfg):
    import jax

    from traffic_sign_detector.ops.mser import mser_regions
    from traffic_sign_detector.ops.preprocess import (
        enhance_contrast,
    )

    return jax.jit(jax.vmap(lambda f: mser_regions(enhance_contrast(f),
                                                   cfg.mser)))


def phase_mser(frames: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp

    from main_detection import operating_point
    from traffic_sign_detector.config import (
        MSERConfig,
        PipelineConfig,
    )
    from traffic_sign_detector.models.detector import (
        DetectionPipeline,
        _detect_batch_packed,
    )
    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
    )
    from traffic_sign_detector.ops import flood_cuda
    from traffic_sign_detector.ops import mser as M

    mser = operating_point(MSERConfig.from_string("MSER_7_200_2000_1"))
    cfg = PipelineConfig(mser=mser, batch_size=MSER_BATCH)
    templates = MeanMaskTemplates.load(TEMPLATES)
    pipe = DetectionPipeline(cfg=cfg, templates=templates)
    names = [f"{i:05d}.ppm" for i in range(len(frames))]
    out, c, r = timed(pipe.dispatch, frames)
    phase_time(f"mser: DetectionPipeline batch {len(frames)} "
               f"({len(frames) / r:.1f} frames/s warm)", c, r)
    dets = pipe.collect(out, names, len(frames))
    check(all(np.isfinite(d.score) for d in dets),
          f"detections finite ({len(dets)} over {len(frames)} frames)")

    props = _proposals_fn(cfg)
    boxes, valid = props(jnp.asarray(frames))
    n_valid = np.asarray(valid).sum(axis=1)
    check((n_valid > 0).all(), f"proposals on every planted frame "
          f"(min {n_valid.min()}, mean {n_valid.mean():.1f})")

    cpu = jax.devices("cpu")[0]
    sub = frames[:2]
    (cb, cv), c, r = timed(props, jax.device_put(sub, cpu))
    phase_time("mser: proposals on the CPU backend, 2 frames", c, r)
    check(np.array_equal(np.asarray(valid)[:2], np.asarray(cv))
          and np.array_equal(np.asarray(boxes)[:2], np.asarray(cb)),
          "proposals == CPU backend, boxes and validity exact")
    red = jax.device_put(templates.red, cpu)
    blue = jax.device_put(templates.blue, cpu)
    c_out = np.asarray(_detect_batch_packed(jax.device_put(sub, cpu), red,
                                            blue, cfg))
    g_out = np.asarray(out)[:2]
    check(np.array_equal(g_out[..., [0, 1, 2, 3, 4, 6]],
                         c_out[..., [0, 1, 2, 3, 4, 6]])
          and np.abs(g_out[..., 5] - c_out[..., 5]).max() <= 1e-4,
          "detections == CPU backend (boxes/types exact, scores 1e-4)")

    if flood_cuda.available():
        rng = np.random.default_rng(9)
        n = MSER_BATCH * mser.max_regions
        mask = rng.random((n, 128, 128)) < 0.55
        mask[:, [0, -1], :] = False
        mask[:, :, [0, -1]] = False
        seeds = rng.integers(1, 127, (n, 2)).astype(np.int32)
        big = 128 * 128 + 1
        kern = jax.jit(lambda m, s: flood_cuda.flood_bbox_cuda(
            m, s, big=big, passes=mser.refine_scan_passes))
        plain = jax.jit(lambda m, s: M._flood_bbox_scan(
            m, s, big=big, passes=mser.refine_scan_passes))
        dm, ds = jnp.asarray(mask), jnp.asarray(seeds)
        got, c, r = timed(kern, dm, ds)
        phase_time(f"mser: CUDA flood kernel, {n} windows", c, r)
        want, c, r = timed(plain, dm, ds)
        phase_time(f"mser: plain scan flood, {n} windows", c, r)
        check(all(np.array_equal(np.asarray(a), np.asarray(b))
                  for a, b in zip(got, want)),
              "CUDA flood == plain scan flood, bit for bit")


def phase_recognition(frames: np.ndarray) -> None:
    import jax

    from traffic_sign_detector.config import PipelineConfig
    from traffic_sign_detector.models.cnn_detector import (
        CNNDetector,
    )
    from traffic_sign_detector.models.rec_pipeline import (
        RecognitionPipeline,
    )
    from traffic_sign_detector.models.recognizer import (
        SignClassifier,
    )

    clf = SignClassifier.load(CLASSIFIER)
    names = [f"{i:05d}.ppm" for i in range(len(frames))]

    def pipeline(dtype: str, cfg: PipelineConfig):
        cnn = CNNDetector.load(PARAMS)
        cnn.cfg = dataclasses.replace(cnn.cfg, score_threshold=0.10,
                                      dtype=dtype)
        return RecognitionPipeline(cfg=cfg, classifier=clf, cnn=cnn)

    prod = pipeline("bfloat16", PipelineConfig())
    dets, c, r = timed(lambda f: prod.recognize_frames(f, names), frames)
    phase_time(f"recognition: CNN proposals -> HOG -> LDA, batch "
               f"{len(frames)}", c, r)
    check(all(np.isfinite(d.score) and 1 <= d.class_id <= 6 for d in dets),
          f"{len(dets)} labeled detections, finite scores, classes 1..6")

    # The same recognition on both backends.  The CNN runs in f32 so the
    # proposal set cannot flip at the threshold between them, and
    # sign_margin 0.5 labels every proposal with its best head, so the
    # comparison covers HOG + all six LDA heads on every proposal.
    cmp_cfg = PipelineConfig(sign_margin=0.5)
    sub = frames[:4]
    with jax.default_matmul_precision("highest"):
        g = pipeline("float32", cmp_cfg).recognize_frames(sub, names[:4])
        with jax.default_device(jax.devices("cpu")[0]):
            c_dets = pipeline("float32", cmp_cfg).recognize_frames(
                sub, names[:4])
    key = lambda d: (d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id)
    check(len(g) > 0 and sorted(map(key, g)) == sorted(map(key, c_dets)),
          f"recognition == CPU backend ({len(g)} labeled proposals, boxes "
          "and labels exact)")
    gs = sorted((key(d), d.score) for d in g)
    cs = sorted((key(d), d.score) for d in c_dets)
    check(all(abs(a[1] - b[1]) <= 1e-4 for a, b in zip(gs, cs)),
          "recognition scores within 1e-4 of the CPU backend")


def four_cards(frames: np.ndarray) -> dict:
    """The --n_devices paths on a flat 4-device data mesh, each compared
    with its one-device result."""
    import jax
    import jax.numpy as jnp

    from main_detection import operating_point
    from traffic_sign_detector.config import (
        MSERConfig,
        PipelineConfig,
    )
    from traffic_sign_detector.models.detector import (
        DetectionPipeline,
    )
    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
    )
    from traffic_sign_detector.models.rec_pipeline import (
        _stack_heads,
        recognize_batch,
    )
    from traffic_sign_detector.models.recognizer import (
        SignClassifier,
    )
    from traffic_sign_detector.parallel.mesh import (
        data_mesh,
        shard_batch,
        sharded_recognize_fn,
    )
    from traffic_sign_detector.parallel.train import (
        distributed_lda_fit,
    )

    devs = jax.devices()
    check(len(devs) == 4, f"4 devices: {devs[0].device_kind}")
    mesh = data_mesh(4)

    mser = operating_point(MSERConfig.from_string("MSER_7_200_2000_1"))
    cfg = PipelineConfig(mser=mser, batch_size=MSER_BATCH)
    templates = MeanMaskTemplates.load(TEMPLATES)
    one = DetectionPipeline(cfg=cfg, templates=templates)
    four = DetectionPipeline(cfg=cfg, templates=templates, mesh=mesh)
    ref, c, r = timed(one.dispatch, frames)
    phase_time(f"4 cards: DetectionPipeline one device, batch "
               f"{len(frames)}", c, r)
    out, c, r = timed(four.dispatch, frames)
    phase_time(f"4 cards: DetectionPipeline over data_mesh(4), batch "
               f"{len(frames)}", c, r)
    names = [f"{i:05d}.ppm" for i in range(len(frames))]
    d1 = one.collect(ref, names, len(frames))
    d4 = four.collect(out, names, len(frames))
    key = lambda d: (d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id,
                     round(d.score, 4))
    check(sorted(map(key, d1)) == sorted(map(key, d4)),
          f"sharded detections == one device ({len(d4)} detections)")

    clf = SignClassifier.load(CLASSIFIER)
    arrays = tuple(jnp.asarray(a) for a in _stack_heads(clf))
    pcfg = PipelineConfig(mser=mser)
    rec4 = sharded_recognize_fn(mesh, pcfg, "HOG", "LDABAYES")
    rec1 = jax.jit(lambda f, a: recognize_batch(f, a, pcfg, "HOG",
                                                "LDABAYES"))
    sub = frames[:8]
    r1, c, r = timed(rec1, jnp.asarray(sub), arrays)
    phase_time("4 cards: recognize_batch one device, 8 frames", c, r)
    r4, c, r = timed(rec4, shard_batch(mesh, sub), arrays)
    phase_time("4 cards: sharded_recognize_fn, 8 frames", c, r)
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in zip(r1[:2] + r1[3:], r4[:2] + r4[3:]))
          and np.abs(np.asarray(r1[2]) - np.asarray(r4[2])).max() <= 1e-5,
          "sharded recognition == one device")

    rng = np.random.default_rng(5)
    n, d = 4096, 324
    y = rng.integers(0, 2, n).astype(np.int32)
    X = (rng.normal(0, 1, (n, d)) + y[:, None] * 0.3).astype(np.float32)
    w = np.ones(n, np.float32)
    fit4 = distributed_lda_fit(mesh, n_classes=2)
    fit1 = distributed_lda_fit(data_mesh(1), n_classes=2)
    (c4, i4), c, r = timed(fit4, *(shard_batch(mesh, a) for a in (X, y, w)))
    phase_time("4 cards: psum LDA fit", c, r)
    c1, i1 = fit1(X, y, w)
    err = max(float(np.abs(np.asarray(c4) - np.asarray(c1)).max()),
              float(np.abs(np.asarray(i4) - np.asarray(i1)).max()))
    scale = float(np.abs(np.asarray(c1)).max())
    check(err <= 1e-3 * max(scale, 1.0), f"psum LDA fit == one-device fit "
          f"(max |d| {err:.2e}, coef scale {scale:.2f})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the multi-device (--n_devices) "
                        "paths on a flat 4-device mesh")
    args = parser.parse_args()
    enable_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        log(f"no GPU: JAX reports {jax.devices()[0].platform}")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line}")
    t0 = time.perf_counter()
    if args.four_cards:
        device = four_cards(synth_frames(MSER_BATCH, seed=11, hw=(H, W)))
    else:
        device = phase_device()
        frames = synth_frames(CNN_BATCH, seed=7, hw=(H, W))
        phase_cnn_float(frames)
        phase_cnn_int8(frames)
        phase_mser(frames[:MSER_BATCH])
        phase_recognition(frames[:MSER_BATCH])
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
