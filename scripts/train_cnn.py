#!/usr/bin/env python3
"""Train the CNN sign detector on GTSDB and score it on the test set.

    python scripts/train_cnn.py --steps 4000 \
        [--out artifacts/cnn_detector/params.npz] [--skip_eval]

Runs on JAX's default backend (``JAX_PLATFORMS=cpu`` for the CPU).  The
whole train set is uploaded to device memory once; the loop is
device-resident
(see models/cnn_train.py).  After training, runs full-frame inference over
test_alumnos_jpg, writes a resultado.txt, and scores it with the parity
stats engine + PASCAL AP.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DET_DATA = "/root/reference/Deteción de Objetos"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_path", default=os.path.join(DET_DATA, "train_jpg"))
    parser.add_argument("--test_path",
                        default=os.path.join(DET_DATA, "test_alumnos_jpg"))
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--min_zoom", type=float, default=0.75)
    parser.add_argument("--max_zoom", type=float, default=1.4,
                        help="upper scale-jitter bound; raise to ~1.75 so "
                        "the upscaled-inference operating points "
                        "(--upscale 1.41-1.6, ops/fused_upscale.py) stay "
                        "inside the training scale distribution")
    parser.add_argument("--threshold", type=float, default=0.35)
    parser.add_argument("--out", default="artifacts/cnn_detector/params.npz")
    parser.add_argument("--resultado", default="cnn_resultado.txt")
    parser.add_argument("--eval_batch", type=int, default=8)
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--eval_only", action="store_true",
                        help="load --out and score it, no training")
    args = parser.parse_args()

    from traffic_sign_detector.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import numpy as np

    from traffic_sign_detector.models import cnn_detector as cd
    from traffic_sign_detector.models import cnn_train as ct

    model_cfg = cd.CNNDetectorConfig(score_threshold=args.threshold)

    if not args.eval_only:
        t0 = time.time()
        data = ct.build_dataset(args.train_path)
        print(f"dataset: {data['frames'].shape} frames, "
              f"{int((data['cls'] > 0).sum())} sign boxes, "
              f"{int((data['cls'] < 0).sum())} ignore boxes "
              f"({time.time() - t0:.1f}s)", flush=True)

        cfg = ct.TrainConfig(batch_size=args.batch, steps=args.steps,
                             lr=args.lr, seed=args.seed,
                             min_zoom=args.min_zoom, max_zoom=args.max_zoom)
        t0 = time.time()
        params, metrics = ct.train(data, model_cfg, cfg)
        print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")
        det = cd.CNNDetector(params, model_cfg)
        det.save(args.out)
        print(f"saved {args.out}")
    else:
        det = cd.CNNDetector.load(args.out, model_cfg)

    if args.skip_eval:
        return

    from traffic_sign_detector.data.images import (
        list_frame_files, load_image_bgr)
    from traffic_sign_detector.eval.ap import score_detection_files
    from traffic_sign_detector.eval.stats import (
        compute_detection_statistics)
    from traffic_sign_detector.utils.serialization import (
        write_results_file)

    files = list_frame_files(args.test_path)
    dets = []
    t0 = time.time()
    for i in range(0, len(files), args.eval_batch):
        chunk = files[i:i + args.eval_batch]
        frames = np.stack([load_image_bgr(os.path.join(args.test_path, f))
                           for f in chunk])
        dets.extend(det.detect_frames(frames, chunk,
                                      orig_hw=frames.shape[1:3]))
    print(f"{len(dets)} detections over {len(files)} frames "
          f"in {time.time() - t0:.1f}s")
    write_results_file(args.resultado, dets)

    gt_path = os.path.join(args.test_path, "gt.txt")
    stats = compute_detection_statistics(dets, gt_path)
    t = stats.total
    print(f"totals: correct {t.correct} incorrect {t.incorrect} missed "
          f"{t.non_detected} | P {t.precision} R {t.recall} F1 {t.f1}")
    ap = score_detection_files(args.resultado, gt_path)
    print(f"PASCAL AP@0.5: {ap['ap']:.4f} (11pt {ap['ap_11pt']:.4f})")


if __name__ == "__main__":
    main()
