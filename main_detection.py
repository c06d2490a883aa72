#!/usr/bin/env python3
"""Práctica-1 CLI: traffic-sign detection over a test directory.

Grammar-compatible with the reference's `Deteción de Objetos/main.py`:

    python main_detection.py --detector MSER_7_200_2000_1 \
        --train_path train_jpg --test_path test_alumnos_jpg

Trains the mean-mask templates from train_path, detects on every frame of
test_path on the device pipeline, writes resultado.txt + annotated frames to
resultado_imgs/, and prints per-type / total precision, recall and F1
statistics against test_path/gt.txt.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

from traffic_sign_detector.config import (
    ConfigError,
    MSERConfig,
    PipelineConfig,
)
from traffic_sign_detector.data.gt import boxes_by_file
from traffic_sign_detector.data.images import (
    list_frame_files,
    load_image_bgr,
)
from traffic_sign_detector.eval.ap import score_detection_files
from traffic_sign_detector.eval.stats import (
    compute_detection_statistics,
    format_stats_report,
)
from traffic_sign_detector.models.detector import DetectionPipeline
from traffic_sign_detector.models.mean_masks import train_mean_masks
from traffic_sign_detector.utils.annotate import (
    draw_boxes_bgr,
    save_image_bgr,
)
from traffic_sign_detector.utils.serialization import write_results_file
from traffic_sign_detector.utils.stages import StageError, stage
from traffic_sign_detector.utils.compile_cache import enable_compile_cache

USAGE_HINT = """\
Detector spec: MSER_<delta>_<minArea>_<maxArea>_<maxVariation>
    delta          integer in (0, 40]
    minArea        integer in (0, 20000], <= maxArea
    maxArea        integer in (0, 20000]
    maxVariation   decimal in (0, 1]
Example: MSER_5_200_3000_0.45
Or the trained CNN family: CNN[_<scoreThreshold>]  (e.g. CNN_0.45);
weights from --cnn_params (train with scripts/train_cnn.py)."""


def _run_cnn(args) -> int:
    """CNN-family orchestration: same 4 stages, trained weights instead of
    mean-mask templates.  Spec grammar: ``CNN`` or ``CNN_<scoreThreshold>``."""
    import os as _os

    from traffic_sign_detector.models.cnn_detector import (
        CNNDetectorConfig,
        saved_meta,
    )
    from traffic_sign_detector.models.cnn_quant import (
        load_detector,
    )

    parts = args.detector.split("_")
    # arch + shipped operating threshold come from the checkpoint's own
    # metadata tags; the CNN_<thr> spec only overrides the threshold
    cfg = CNNDetectorConfig(**(saved_meta(args.cnn_params)
                               if _os.path.exists(args.cnn_params) else {}))
    if len(parts) > 2 or (len(parts) == 2 and not parts[1]):
        print(f"Invalid detector spec: {args.detector!r}\n{USAGE_HINT}")
        return 2
    if len(parts) == 2:
        try:
            thr = float(parts[1])
            if not 0.0 < thr < 1.0:
                raise ValueError
        except ValueError:
            print(f"Invalid CNN score threshold: {parts[1]!r}\n{USAGE_HINT}")
            return 2
        cfg = dataclasses.replace(cfg, score_threshold=thr)

    test_path = args.test_path.replace("\\", "/")
    try:
        print(f"[1/4] loading CNN detector weights from {args.cnn_params} ...")
        with stage("load CNN detector weights"):
            # float or int8 artifact, chosen by the checkpoint's own
            # __quant__ tag (models/cnn_quant.py)
            det = load_detector(args.cnn_params, cfg, upscale=args.upscale)
        if args.upscale != 1.0:
            print(f"      upscaled inference x{args.upscale:g} "
                  "(on-device bilinear; boxes in native coordinates)")

        print(f"[2/4] detecting over {test_path} "
              f"(score threshold {cfg.score_threshold}) ...")
        with stage("detect over test directory"):
            t0 = time.time()
            detections = det.run_directory(
                test_path, batch_size=args.batch_size, progress=True,
                input_format=args.input_format)
            dt = time.time() - t0
            n_frames = len(list_frame_files(test_path))
            print(f"      {len(detections)} detections over {n_frames} "
                  f"frames in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} fps)")

        print(f"[3/4] writing {args.out}"
              + ("" if args.no_images else f" and {args.out_imgs}/"))
        with stage("serialize results"):
            write_results_file(args.out, detections)
            if not args.no_images:
                if os.path.isdir(args.out_imgs):
                    shutil.rmtree(args.out_imgs)
                os.mkdir(args.out_imgs)
                per_file = boxes_by_file(detections)
                for fname in list_frame_files(test_path):
                    img = load_image_bgr(os.path.join(test_path, fname))
                    boxes = [(d.x1, d.y1, d.x2, d.y2)
                             for d in per_file.get(fname, [])]
                    save_image_bgr(os.path.join(args.out_imgs, fname),
                                   draw_boxes_bgr(img, boxes))

        gt_path = os.path.join(test_path, "gt.txt")
        if os.path.exists(gt_path):
            print("[4/4] statistics vs", gt_path)
            with stage("statistics vs ground truth"):
                stats = compute_detection_statistics(detections, gt_path)
                print(format_stats_report(stats, per_file=args.per_file_stats))
                ap = score_detection_files(args.out, gt_path)
                print(f"\nPASCAL AP@0.5: {ap['ap']:.4f}  "
                      f"(11pt: {ap['ap_11pt']:.4f}, "
                      f"{ap['n_det']} detections, {ap['n_gt']} GT)")
        else:
            print("[4/4] no gt.txt found; skipping statistics")
    except StageError:
        return 1
    return 0


def operating_point(mser: MSERConfig, downscale: int = 2,
                    max_regions: int = 128,
                    pixel_area_stability: bool = False) -> MSERConfig:
    """The CLI's MSER operating point for a parsed detector spec."""
    if downscale > 1 and not pixel_area_stability:
        # bbox-area sweep's tuned operating point (PARITY.md round-3 knee)
        mser = dataclasses.replace(mser, downscale=downscale, ccl_iters=2,
                                   level_step=9, ccl_jumps=0)
    if max_regions:
        mser = dataclasses.replace(mser, max_regions=max_regions)
    if pixel_area_stability:
        # the pixel-area sweep keeps ITS tuned params (iters 8, auto level
        # step — iters 2 / step 9 collapse this path to F1 0.03, measured)
        mser = dataclasses.replace(mser, downscale=downscale,
                                   fused_sweep=False)
    return mser


def main(argv=None) -> int:
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="Trains and executes a detector over a set of testing images"
    )
    parser.add_argument("--detector", type=str, default="MSER_7_200_2000_1",
                        help="Detector string (default: MSER_7_200_2000_1)")
    parser.add_argument("--train_path", default="train_jpg")
    parser.add_argument("--test_path", default="test_alumnos_jpg")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--input_format", default="bgr",
                        choices=["bgr", "yuv420", "yuv420p", "patches8"],
                        help="CNN-detector decode layout: yuv420 ships raw "
                        "JPEG 4:2:0 planes (half the host->device bytes, "
                        "libjpeg-exact device conversion; auto-upgraded to "
                        "the patchified yuv420p layout on the v3 arch — "
                        "zero on-device relayout); patches8 decodes into "
                        "the stem's matmul layout (fastest full-bandwidth "
                        "path).  Ignored by the MSER pipeline (bgr only)")
    parser.add_argument("--upscale", type=float, default=1.0,
                        help="CNN-detector upscaled-inference factor: frames "
                        "are virtually upscaled before the forward and "
                        "boxes mapped back to native coordinates; for "
                        "fusable ratios the resize folds into the stem "
                        "(ops/fused_upscale.py) and no upscaled frame is "
                        "materialized.  1.6 is the measured quality "
                        "flagship on native GTSDB frames: F1 0.81 -> 0.85, "
                        "AP 0.857 -> 0.954 (PARITY.md).  bgr/yuv420 "
                        "ingest only")
    parser.add_argument("--out", default="resultado.txt")
    parser.add_argument("--out_imgs", default="resultado_imgs")
    parser.add_argument("--no-images", action="store_true",
                        help="skip writing annotated frames")
    parser.add_argument("--per-file-stats", action="store_true")
    parser.add_argument("--downscale", type=int, default=2,
                        help="MSER-stage downscale (2 = tuned fast mode, the "
                             "shipped quality/speed winner; 1 = native-res "
                             "sweep)")
    parser.add_argument("--max_regions", type=int, default=128,
                        help="proposal capacity per frame (256 = tuned "
                             "default, beats larger caps on F1/AP)")
    parser.add_argument("--n_devices", type=int, default=0,
                        help="shard each batch over this many devices "
                             "(0 = single device)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage wall-clock summary")
    parser.add_argument("--trace_dir", default=None,
                        help="capture a jax profiler trace to this directory")
    parser.add_argument("--cnn_params",
                        default="artifacts/cnn_detector/params.npz",
                        help="weights for --detector CNN")
    parser.add_argument("--pixel_area_stability", action="store_true",
                        help="use OpenCV's exact pixel-count stability "
                             "semantics (level sweep with a per-level "
                             "component-area scatter) instead of the default "
                             "sweep's bbox-area substitute — for "
                             "semantics-parity studies (both paths share the "
                             "refine flood's exact pixel-area window)")
    args = parser.parse_args(argv)

    if args.upscale <= 0:
        print(f"Invalid --upscale {args.upscale!r}: must be > 0")
        return 2
    if args.upscale != 1.0 and args.input_format in ("patches8", "yuv420p"):
        print("--upscale needs full frames; patches8/yuv420p are "
              "pre-patchified at native resolution (use --input_format "
              "bgr or yuv420)")
        return 2

    if args.detector.upper().startswith("CNN"):
        return _run_cnn(args)

    try:
        mser = MSERConfig.from_string(args.detector)
    except ConfigError as e:
        print(f"Invalid detector spec: {e}\n{USAGE_HINT}")
        return 2

    from traffic_sign_detector.utils.profiling import (
        StageProfiler,
        xla_trace,
    )

    mser = operating_point(mser, args.downscale, args.max_regions,
                           args.pixel_area_stability)
    cfg = PipelineConfig(mser=mser, batch_size=args.batch_size)
    train_path = args.train_path.replace("\\", "/")
    test_path = args.test_path.replace("\\", "/")
    prof = StageProfiler()

    # Stage-level failure isolation, matching the reference orchestrator's
    # per-stage try/except banners (`Deteción de Objetos/source.py:618-626`):
    # a failing stage prints one banner and stops cleanly (exit code 1).
    try:
        print(f"[1/4] training mean-mask templates from {train_path} ...")
        t0 = time.time()
        with stage("train mean-mask templates"), prof.stage("train_templates"):
            templates = train_mean_masks(train_path)
        print(f"      done in {time.time() - t0:.1f}s")

        print(f"[2/4] detecting over {test_path} "
              f"(delta={mser.delta} area=[{mser.min_area},{mser.max_area}] "
              f"maxVar={mser.max_variation}) ...")
        with stage("detect over test directory"):
            mesh = None
            if args.n_devices:
                from traffic_sign_detector.parallel.mesh import (
                    data_mesh,
                )

                mesh = data_mesh(args.n_devices)
                print(f"      sharding batches over {args.n_devices} devices")
            pipe = DetectionPipeline(cfg=cfg, templates=templates, mesh=mesh)
            t0 = time.time()
            n_total = len(list_frame_files(test_path))
            with xla_trace(args.trace_dir), prof.stage("detect", items=n_total):
                detections = pipe.run_directory(test_path, progress=True)
            dt = time.time() - t0
            n_frames = len(list_frame_files(test_path))
            print(f"      {len(detections)} detections over {n_frames} frames "
                  f"in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} fps)")

        print(f"[3/4] writing {args.out}"
              + ("" if args.no_images else f" and {args.out_imgs}/"))
        with stage("serialize results"):
            write_results_file(args.out, detections)
            if not args.no_images:
                if os.path.isdir(args.out_imgs):
                    shutil.rmtree(args.out_imgs)
                os.mkdir(args.out_imgs)
                per_file = boxes_by_file(detections)
                for fname in list_frame_files(test_path):
                    img = load_image_bgr(os.path.join(test_path, fname))
                    boxes = [(d.x1, d.y1, d.x2, d.y2)
                             for d in per_file.get(fname, [])]
                    save_image_bgr(
                        os.path.join(args.out_imgs, fname),
                        draw_boxes_bgr(img, boxes),
                    )

        gt_path = os.path.join(test_path, "gt.txt")
        if os.path.exists(gt_path):
            print("[4/4] statistics vs", gt_path)
            with stage("statistics vs ground truth"):
                stats = compute_detection_statistics(detections, gt_path)
                print(format_stats_report(stats, per_file=args.per_file_stats))
                ap = score_detection_files(args.out, gt_path)
                print(f"\nPASCAL AP@0.5: {ap['ap']:.4f}  "
                      f"(11pt: {ap['ap_11pt']:.4f}, "
                      f"{ap['n_det']} detections, {ap['n_gt']} GT)")
        else:
            print("[4/4] no gt.txt found; skipping statistics")
    except StageError:
        return 1

    if args.profile:
        print("\n== stage profile ==")
        print(prof.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
