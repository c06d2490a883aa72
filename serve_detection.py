#!/usr/bin/env python3
"""Streaming detection server: watch a directory, emit JSONL detections.

Production-serving surface over the same fused device pipeline as
`main_detection.py` (the reference has no serving mode; its loop is a
one-shot batch over a fixed directory, `Deteción de Objetos/
source.py:95-131`).  Frames appearing in ``--watch_dir`` are decoded with
the native loader, batched with a bounded linger so tail latency stays
controlled (a partial batch is padded and flushed after ``--max_wait_ms``),
pushed through `detect_batch`, and appended to ``--out`` as one JSON object
per frame:

    {"file": "00600.jpg", "latency_ms": 41.3,
     "detections": [{"box": [x1, y1, x2, y2], "type": 3, "score": 0.78}]}

    python serve_detection.py --watch_dir incoming/ --out results.jsonl
    python serve_detection.py --watch_dir dir/ --once   # drain + exit

``--once`` processes the frames present and exits (used by tests and for
cron-style operation); otherwise the server polls for new files until
SIGINT.  On exit it prints a latency/throughput report (p50/p95/p99 per
frame, decode->result).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from traffic_sign_detector.utils.compile_cache import enable_compile_cache


def _percentile(sorted_vals, p):
    if not sorted_vals:
        return float("nan")
    k = min(len(sorted_vals) - 1, max(0, int(round(p / 100 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def main(argv=None) -> int:
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="Streaming sign detector")
    parser.add_argument("--watch_dir", required=True)
    parser.add_argument("--out", default="detections.jsonl")
    parser.add_argument("--detector", default="MSER_7_200_2000_1",
                        help="MSER_<d>_<minA>_<maxA>_<maxVar> (parity "
                             "pipeline) or CNN[_<scoreThreshold>] (trained "
                             "flagship; weights from --cnn_params)")
    parser.add_argument("--cnn_params",
                        default="artifacts/cnn_detector/params.npz")
    parser.add_argument("--templates", default="mean_masks.npz",
                        help="trained mean-mask templates (see "
                             "main_detection.py; trained on first use if "
                             "missing and --train_path is given)")
    parser.add_argument("--train_path", default=None)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--input_format", default="bgr",
                        choices=["bgr", "yuv420", "yuv420p", "patches8"],
                        help="decode layout for the CNN detector: yuv420 "
                        "halves the host->device feed bytes (device-side "
                        "libjpeg-exact conversion; yuv420p = same bytes "
                        "patchified at decode time, zero on-device "
                        "relayout), patches8 decodes into the stem's "
                        "matmul layout (fastest full-bandwidth path); "
                        "MSER requires bgr")
    parser.add_argument("--max_wait_ms", type=float, default=200.0,
                        help="max linger before flushing a partial batch")
    parser.add_argument("--poll_ms", type=float, default=50.0)
    parser.add_argument("--upscale", type=float, default=1.0,
                        help="CNN upscaled-inference QUALITY mode: frames "
                        "are virtually upscaled by this factor (1.6 is "
                        "the measured sweet spot: F1 0.85 / AP 0.95) with "
                        "the resize folded into the stem "
                        "for fusable ratios (ops/fused_upscale.py — no "
                        "materialized upscaled frame), boxes emitted in "
                        "native coordinates; bgr/yuv420 ingest only")
    parser.add_argument("--downscale", type=int, default=2)
    parser.add_argument("--max_regions", type=int, default=128)
    parser.add_argument("--once", action="store_true",
                        help="process existing frames, then exit")
    args = parser.parse_args(argv)

    import dataclasses as _dc

    import numpy as np

    from traffic_sign_detector.config import (
        ConfigError,
        MSERConfig,
        PipelineConfig,
    )
    from traffic_sign_detector.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from traffic_sign_detector.models.detector import (
        DetectionPipeline,
    )
    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
        train_mean_masks,
    )

    use_cnn = args.detector.upper().startswith("CNN")
    if args.input_format != "bgr" and not use_cnn:
        print("--input_format yuv420/patches8 requires --detector CNN "
              "(the MSER pipeline's color ops are defined on the "
              "cv2.imread-parity BGR decode)")
        return 2
    if args.upscale != 1.0 and (not use_cnn or args.input_format
                                in ("patches8", "yuv420p")):
        print("--upscale requires --detector CNN with bgr/yuv420 ingest "
              "(patches8/yuv420p are pre-patchified at native resolution)")
        return 2
    if use_cnn:
        # Flagship family: same dispatch/collect contract, trained weights
        # instead of mean-mask templates (models/cnn_detector.py).
        from traffic_sign_detector.models.cnn_detector import (
            CNNDetectorConfig,
            saved_meta,
        )
        from traffic_sign_detector.models.cnn_quant import (
            load_detector,
        )

        parts = args.detector.split("_")
        ccfg = CNNDetectorConfig(**(saved_meta(args.cnn_params)
                                    if os.path.exists(args.cnn_params)
                                    else {}))
        if len(parts) == 2:
            try:
                ccfg = _dc.replace(ccfg, score_threshold=float(parts[1]))
            except ValueError:
                print(f"Invalid CNN score threshold: {parts[1]!r}")
                return 2
        elif len(parts) > 2:
            print(f"Invalid spec: {args.detector!r} (CNN[_<threshold>])")
            return 2
        if not os.path.exists(args.cnn_params):
            print(f"CNN weights {args.cnn_params!r} not found "
                  "(train with scripts/train_cnn.py)")
            return 2
        cnn = load_detector(args.cnn_params, ccfg, upscale=args.upscale)

        class _CNNPipe:
            """Adapt CNNDetector to the server's (out, names, batch) collect.

            frames may already be device arrays (batched_frames pre-uploads);
            CNNDetector.dispatch's jnp.asarray is a no-op for those.
            """

            _orig_hw = None

            def dispatch(self, frames):
                # capture the frame bounds so collect can clip CNN boxes to
                # the image (near-edge boxes otherwise leave the frame —
                # mirrors CNNDetector.run_directory)
                if isinstance(frames, tuple):  # yuv420 planes (y, cb, cr)
                    s = 8 if frames[0].ndim == 4 else 1  # yuv420p patches
                    self._orig_hw = (int(frames[0].shape[1]) * s,
                                     int(frames[0].shape[2]) * s)
                    return cnn.dispatch_yuv(*frames)
                scale = 8 if frames.shape[-1] == 192 else 1  # patches8
                self._orig_hw = (int(frames.shape[1]) * scale,
                                 int(frames.shape[2]) * scale)
                return cnn.dispatch(frames)

            def collect(self, out, names, batch):
                return cnn.collect(out, names, orig_hw=self._orig_hw)

            def detect_frames(self, frames, names):
                return cnn.detect_frames(
                    frames, names,
                    orig_hw=(int(frames.shape[1]), int(frames.shape[2])))

        pipe = _CNNPipe()
    else:
        try:
            mser = MSERConfig.from_string(args.detector)
        except ConfigError as e:
            print(f"Invalid spec: {e}")
            return 2
        if args.downscale > 1:
            mser = _dc.replace(mser, downscale=args.downscale, ccl_iters=2,
                               level_step=9, ccl_jumps=0)
        if args.max_regions:
            mser = _dc.replace(mser, max_regions=args.max_regions)
        cfg = PipelineConfig(mser=mser, batch_size=args.batch)

        if os.path.exists(args.templates):
            templates = MeanMaskTemplates.load(args.templates)
        elif args.train_path:
            templates = train_mean_masks(args.train_path)
            templates.save(args.templates)
        else:
            print(f"templates file {args.templates!r} not found and no "
                  "--train_path given")
            return 2

        pipe = DetectionPipeline(cfg=cfg, templates=templates)
    seen: set[str] = set()
    latencies: list[float] = []
    n_frames = 0
    warmed = False
    t_start = time.time()

    def flush(batch_files, batch_arrivals, out_fh):
        """Process any number of pending frames with the same decode-ahead +
        pre-upload + dispatch/collect overlap as the batch CLI — a drain of
        K batches runs at run_directory throughput, not serial per-batch."""
        nonlocal n_frames
        if not batch_files:
            return
        from traffic_sign_detector.data.prefetch import (
            batched_frames,
        )

        arrival_of = dict(zip(batch_files, batch_arrivals))

        def emit(out, names):
            nonlocal n_frames
            dets = pipe.collect(out, names, args.batch)
            done = time.time()
            by_file: dict[str, list] = {}
            for d in dets:
                if d.filename != "__pad__":
                    by_file.setdefault(d.filename, []).append(d)
            for f in names:
                if f == "__pad__":
                    continue
                lat = (done - arrival_of[f]) * 1e3
                latencies.append(lat)
                n_frames += 1
                out_fh.write(json.dumps({
                    "file": f,
                    "latency_ms": round(lat, 1),
                    "detections": [
                        {"box": [d.x1, d.y1, d.x2, d.y2],
                         "type": d.class_id, "score": d.score}
                        for d in by_file.get(f, [])
                    ],
                }) + "\n")
            out_fh.flush()

        in_flight = None
        for frames, names in batched_frames(
            args.watch_dir, batch_files, args.batch, device_put=True,
            input_format=args.input_format if use_cnn else "bgr",
        ):
            out = pipe.dispatch(frames)
            if in_flight is not None:
                emit(*in_flight)
            in_flight = (out, names)
        if in_flight is not None:
            emit(*in_flight)

    print(f"serving {args.watch_dir} -> {args.out} "
          f"(batch {args.batch}, linger {args.max_wait_ms} ms"
          f"{', drain-once' if args.once else ''})")
    pending: list[str] = []
    arrivals: list[float] = []
    first_pending = None
    try:
        with open(args.out, "a", encoding="utf-8") as out_fh:
            while True:
                now = time.time()
                for f in list_frame_files(args.watch_dir):
                    if f not in seen:
                        seen.add(f)
                        pending.append(f)
                        arrivals.append(now)
                        if first_pending is None:
                            first_pending = now
                if pending and not warmed:
                    # one-time XLA compile before serving starts; frames
                    # are billed from server readiness, not from before it
                    frame0 = load_image_bgr(
                        os.path.join(args.watch_dir, pending[0])
                    )
                    pipe.detect_frames(
                        np.stack([frame0] * args.batch),
                        ["__pad__"] * args.batch,
                    )
                    warmed = True
                    now = time.time()
                    arrivals = [now] * len(arrivals)
                    first_pending = now
                    t_start = now  # fps report also bills from readiness
                while len(pending) >= args.batch:
                    flush(pending[: args.batch], arrivals[: args.batch],
                          out_fh)
                    pending = pending[args.batch :]
                    arrivals = arrivals[args.batch :]
                    first_pending = time.time() if pending else None
                lingered = (
                    first_pending is not None
                    and (now - first_pending) * 1e3 >= args.max_wait_ms
                )
                if pending and (lingered or args.once):
                    flush(pending, arrivals, out_fh)
                    pending, arrivals, first_pending = [], [], None
                if args.once and not pending:
                    break
                time.sleep(args.poll_ms / 1e3)
    except KeyboardInterrupt:
        pass

    wall = time.time() - t_start
    lat_sorted = sorted(latencies)
    print(f"{n_frames} frames in {wall:.1f}s "
          f"({n_frames / max(wall, 1e-9):.1f} fps) | latency ms "
          f"p50 {_percentile(lat_sorted, 50):.0f} "
          f"p95 {_percentile(lat_sorted, 95):.0f} "
          f"p99 {_percentile(lat_sorted, 99):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
