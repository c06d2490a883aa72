#!/usr/bin/env python3
"""Run a saved recognition model over the test set and score it.

    python scripts/rec_test_run.py --model /tmp/sign_classifier \
        [--downscale 2] [--out /tmp/rec_resultado.txt]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="/tmp/sign_classifier")
    parser.add_argument("--test_path",
                        default="/root/reference/Deteción de Objetos/test_alumnos_jpg")
    parser.add_argument("--downscale", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--no_sign_tol", type=float, default=0.5)
    parser.add_argument("--rec_grows", default="1.15",
                        help="comma list of proposal grow factors")
    parser.add_argument("--sign_margin", type=float, default=0.0,
                        help="accept p_sign >= 0.5 - margin (P/R dial)")
    parser.add_argument("--max_regions", type=int, default=384)
    parser.add_argument("--out", default="/tmp/rec_resultado.txt")
    args = parser.parse_args()

    from traffic_sign_detector.config import MSERConfig, PipelineConfig
    from traffic_sign_detector.eval.ap import score_detection_files
    from traffic_sign_detector.eval.stats import (
        compute_detection_statistics,
    )
    from traffic_sign_detector.models.rec_pipeline import (
        RecognitionPipeline,
    )
    from traffic_sign_detector.models.recognizer import SignClassifier
    from traffic_sign_detector.utils.serialization import (
        write_results_file,
    )

    clf = SignClassifier.load(args.model)
    print(f"loaded {clf.config.to_string()} from {args.model}")
    if clf.proposal_spec:
        print(f"  trained on proposal distribution: {clf.proposal_spec} "
              "(keep inference proposals matched — see note below)")
    # NB: keep the proposal distribution matched to training (max_regions
    # 512, level_step = delta): a tighter tuned detector config starves the
    # classifier of candidates (measured: AP drops 0.141 -> 0.048).
    mser = MSERConfig(max_variation=1.0, max_regions=args.max_regions,
                      downscale=args.downscale,
                      ccl_iters=8 if args.downscale > 1 else 16,
                      ccl_jumps=0 if args.downscale > 1 else 1)
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(mser=mser, batch_size=args.batch,
                           no_sign_tol=args.no_sign_tol,
                           sign_margin=args.sign_margin,
                           rec_grows=tuple(float(g) for g in
                                           args.rec_grows.split(","))),
        classifier=clf,
    )
    t0 = time.time()
    dets = pipe.run_directory(args.test_path, progress=True)
    dt = time.time() - t0
    print(f"{len(dets)} detections in {dt:.1f}s")
    write_results_file(args.out, dets)

    gt_path = os.path.join(args.test_path, "gt.txt")
    stats = compute_detection_statistics(dets, gt_path)
    t = stats.total
    print(f"totals: correct {t.correct} incorrect {t.incorrect} missed "
          f"{t.non_detected} | P {t.precision} R {t.recall} F1 {t.f1}")
    ap = score_detection_files(args.out, gt_path)
    print(f"PASCAL AP@0.5: {ap['ap']:.4f} (11pt {ap['ap_11pt']:.4f})")


if __name__ == "__main__":
    main()
