#!/usr/bin/env python3
"""Práctica-2 CLI: train + validate the traffic-sign recognizer.

Grammar-compatible with the reference's `Reconocimiento de Objetos/main.py`:

    python main_recognition.py --detector MSER_7_200_2000_1 \
        --classifier HOG_LDA_BAYES --train_path train_jpg [--no-validate]

Builds the training set (GT positives + MSER-mined negatives, proposal cache
on disk), trains the configured classifier, runs the 10% held-out
validation, prints the confusion matrix and classification report, and saves
the trained model.

Divergences from the reference CLI (`Reconocimiento de Objetos/main.py`):
validation runs unconditionally instead of behind the interactive s/n
prompt (whose "n" branch was unreachable anyway, main.py:62), and the
test-set run the reference ships commented out (main.py:64) is exposed as
--run_test.  The classifier grammar accepts both the reference's default
spelling HOG_LDA_BAYES and the whitelist spelling HOG_LDA_LDABAYES.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from traffic_sign_detector.config import (
    ClassifierConfig,
    ConfigError,
    MSERConfig,
)
from traffic_sign_detector.constants import SIGN_NAMES
from traffic_sign_detector.models.recognizer import run_validation
from traffic_sign_detector.utils.stages import StageError, stage
from traffic_sign_detector.utils.compile_cache import enable_compile_cache


def main(argv=None) -> int:
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="Trains a classifier on train data and validates it"
    )
    parser.add_argument("--train_path", type=str, default="./train_jpg")
    parser.add_argument("--test_path", type=str, default="./test_alumnos_jpg")
    parser.add_argument("--detector", type=str, default="MSER_7_200_2000_1")
    parser.add_argument("--classifier", type=str, default="HOG_LDA_BAYES")
    parser.add_argument("--validation_pct", type=float, default=0.1)
    parser.add_argument("--no_sign_tol", type=float, default=0.5)
    parser.add_argument("--cache", default="mser_proposals_cache.npz",
                        help="proposal cache artifact (replaces MSERTrain.val)")
    parser.add_argument("--model_out", default="sign_classifier",
                        help="directory to save the trained model")
    parser.add_argument("--limit", type=int, default=None,
                        help="limit training frames (debugging)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_test", action="store_true",
                        help="after training, run the recognizer over "
                             "test_path and write resultado.txt")
    parser.add_argument("--out", default="resultado.txt")
    parser.add_argument("--confusion_plot", default=None,
                        help="write the validation confusion matrix PNG here")
    parser.add_argument("--downscale", type=int, default=1,
                        help="MSER-stage downscale for negative mining "
                             "(2 = fast mode)")
    parser.add_argument("--sweep_configs", action="store_true",
                        help="validate all four classifier configs "
                             "(HOG/GRAY x LDABAYES/KNN) and print an "
                             "accuracy summary — the multi-config loop the "
                             "reference ships commented out "
                             "(`Reconocimiento de Objetos/main.py:96-103`)")
    parser.add_argument("--rec_grows", default="1.15",
                        help="comma list of proposal grow factors; the "
                             "union of grown proposal sets is classified "
                             "(reference: single 1.15). Multiple factors "
                             "raise the proposal-recall ceiling — MSER "
                             "components are often a sign's inner region")
    parser.add_argument("--proposal_positives", action="store_true",
                        help="also label train-set MSER proposals with "
                             "IoU>0.5 vs GT as positives of that class — "
                             "matches the training distribution to the "
                             "inference distribution (the reference trains "
                             "on pixel-exact GT crops only, the dominant "
                             "recall limiter; see models/recognizer.py)")
    parser.add_argument("--proposals", default="auto",
                        help="proposal source: CNN[_<thr>] (the default "
                             "when the flagship weights exist — its "
                             "low-threshold boxes, default thr 0.10, feed "
                             "the trained classifier and beat the "
                             "instructor golden: F1 0.84 / AP 0.78 vs "
                             "0.74 / 0.742) or MSER (the reference-parity "
                             "source, capped by the MSER proposal-recall "
                             "ceiling; scripts/proposal_recall.py).  "
                             "'auto' = CNN if --cnn_params exists, else "
                             "MSER")
    parser.add_argument("--cnn_params",
                        default="artifacts/cnn_detector/params.npz",
                        help="CNN weights for --proposals CNN")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="fit the classifier with the SPMD "
                             "sufficient-statistics trainer over an "
                             "N-device data mesh (matches the detection "
                             "CLI's scale-out flag)")
    args = parser.parse_args(argv)

    # The reference grammar defaults to ./train_jpg relative to the dataset
    # directory (`Reconocimiento de Objetos/main.py:36-45`); when invoked
    # from elsewhere, fall back to the reference dataset if present.
    _ref = "/root/reference/Deteción de Objetos"
    for attr, sub in (("train_path", "train_jpg"), ("test_path", "test_alumnos_jpg")):
        p = getattr(args, attr)
        if p == f"./{sub}" and not os.path.isdir(p) and os.path.isdir(
            os.path.join(_ref, sub)
        ):
            setattr(args, attr, os.path.join(_ref, sub))

    try:
        mser = MSERConfig.from_string(args.detector)
        clf_cfg = ClassifierConfig.from_string(args.classifier)
    except ConfigError as e:
        print(f"Invalid spec: {e}")
        return 2
    if args.downscale > 1:
        import dataclasses as _dc

        # Recognition mining favors proposal coverage over sweep speed
        # (training is offline): auto level step + iters 8.  Measured
        # proposal-recall ceilings (scripts/proposal_recall, grows
        # 1.15+1.3): iters 24 -> 0.664, iters 8 -> 0.651, the detection
        # CLI's speed-tuned (iters 2, step 9) sweep -> 0.610; iters 8 is
        # the knee (2.5x less propagation work than 24 for 1% ceiling).
        mser = _dc.replace(mser, downscale=args.downscale, ccl_iters=8,
                           ccl_jumps=0)

    # Stage-level failure isolation, matching the reference validation
    # harness's per-stage try/except banners (`Reconocimiento de
    # Objetos/source.py:653-661`).
    try:
        return _run(args, mser, clf_cfg)
    except StageError:
        return 1


def _parse_cnn_proposals(args):
    """--proposals CNN[_thr] -> a loaded CNNDetector at that threshold
    (None when the source is MSER).

    Default "auto" resolves to CNN when the flagship weights exist — the
    golden-beating recipe ships as the default CLI behavior; --proposals MSER
    remains the reference-parity flag."""
    spec = args.proposals.upper()
    if spec == "AUTO":
        if os.path.exists(args.cnn_params):
            spec = "CNN"
            args.proposals = "CNN"
        else:
            print("note: flagship CNN weights not found at "
                  f"{args.cnn_params}; falling back to --proposals MSER")
            return None
    if not spec.startswith("CNN"):
        if spec != "MSER":
            raise SystemExit(f"Invalid --proposals spec: {args.proposals!r} "
                             "(MSER or CNN[_<thr>])")
        return None
    import dataclasses as _dc

    from traffic_sign_detector.models.cnn_detector import (
        CNNDetector,
    )

    parts = args.proposals.split("_")
    thr = float(parts[1]) if len(parts) == 2 and parts[1] else 0.10
    det = CNNDetector.load(args.cnn_params)
    det.cfg = _dc.replace(det.cfg, score_threshold=thr)
    return det


def _run(args, mser, clf_cfg) -> int:
    if args.sweep_configs:
        return _run_sweep(args, mser)
    print(f"validating {clf_cfg.to_string()} with detector {mser.to_string()}")
    t0 = time.time()
    mesh = None
    if args.n_devices > 1:
        import jax

        from traffic_sign_detector.parallel.mesh import data_mesh

        avail = len(jax.devices())
        if args.n_devices > avail:
            print(f"--n_devices {args.n_devices} > {avail} available "
                  f"device(s); for CPU testing set JAX_PLATFORMS=cpu and "
                  f"XLA_FLAGS="
                  f"--xla_force_host_platform_device_count={args.n_devices}")
            return 2
        mesh = data_mesh(args.n_devices)
    cnn_det = _parse_cnn_proposals(args)
    proposals = None
    if cnn_det is not None:
        from traffic_sign_detector.models.recognizer import (
            extract_train_proposals_cnn,
        )

        with stage("mine CNN proposals over the train set"):
            proposals = extract_train_proposals_cnn(
                args.train_path.replace("\\", "/"), cnn_det,
                cache_path=args.cache, limit=args.limit,
            )
        n_props = sum(len(b) for b, _ in proposals.values())
        print(f"{n_props} CNN proposals at thr "
              f"{cnn_det.cfg.score_threshold:g}")
    with stage("train + validate classifier"):
        result = run_validation(
            args.train_path.replace("\\", "/"),
            mser_cfg=mser,
            clf_cfg=clf_cfg,
            validation_pct=args.validation_pct,
            no_sign_tol=args.no_sign_tol,
            cache_path=args.cache,
            limit=args.limit,
            seed=args.seed,
            verbose=True,
            mesh=mesh,
            # CNN proposals are only useful with matched-distribution
            # positives (round-3 diagnosis), so they imply the flag
            proposal_positives=args.proposal_positives or cnn_det is not None,
            grows=tuple(float(g) for g in args.rec_grows.split(",")),
            proposals=proposals,
        )
    print(f"\ntraining + validation took {time.time() - t0:.1f}s")
    print("\nconfusion matrix (rows = true, cols = predicted):")
    header = " ".join(f"{n[:6]:>7}" for n in SIGN_NAMES)
    print(f"{'':>15}{header}")
    for i, row in enumerate(result.confusion):
        print(f"{SIGN_NAMES[i]:>15}" + " ".join(f"{v:7d}" for v in row))
    print("\n" + result.report)
    print(f"\nvalidation accuracy: {result.accuracy:.4f}")

    if args.confusion_plot:
        _write_confusion_plot(args, result)

    with stage("save trained model"):
        result.classifier.save(args.model_out)
        print(f"model saved to {args.model_out}/")

    if args.run_test:
        with stage("recognizer test-set inference"):
            _run_test(args, mser, result, cnn_det)
    return 0


def _run_sweep(args, mser) -> int:
    """Validate every classifier config; the reference's commented-out
    multi-config loop (`Reconocimiento de Objetos/main.py:96-103`)."""
    grows = tuple(float(g) for g in args.rec_grows.split(","))
    rows = []
    for spec in ("HOG_LDA_BAYES", "HOG_LDA_KNN",
                 "GRAY_LDA_BAYES", "GRAY_LDA_KNN"):
        cfg = ClassifierConfig.from_string(spec)
        print(f"\n=== {spec} ===")
        t0 = time.time()
        with stage(f"train + validate {spec}"):
            result = run_validation(
                args.train_path.replace("\\", "/"),
                mser_cfg=mser,
                clf_cfg=cfg,
                validation_pct=args.validation_pct,
                no_sign_tol=args.no_sign_tol,
                cache_path=args.cache,  # proposal cache shared across configs
                limit=args.limit,
                seed=args.seed,
                verbose=False,
                proposal_positives=args.proposal_positives,
                grows=grows,
            )
        rows.append((spec, result.accuracy, time.time() - t0))
        print(result.report)
    print("\n== summary (validation accuracy) ==")
    for spec, acc, dt in rows:
        print(f"  {spec:<16} {acc:.4f}  ({dt:.1f}s)")
    return 0


def _write_confusion_plot(args, result) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(result.confusion, cmap="Blues")
    ax.set_xticks(range(len(SIGN_NAMES)))
    ax.set_yticks(range(len(SIGN_NAMES)))
    ax.set_xticklabels(SIGN_NAMES, rotation=45, ha="right")
    ax.set_yticklabels(SIGN_NAMES)
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    for i in range(result.confusion.shape[0]):
        for j in range(result.confusion.shape[1]):
            ax.text(j, i, str(result.confusion[i, j]),
                    ha="center", va="center", fontsize=8)
    ax.set_title(f"clasificador {args.classifier}")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(args.confusion_plot, dpi=120)
    print(f"confusion matrix plot saved to {args.confusion_plot}")


def _run_test(args, mser, result, cnn_det=None) -> None:
    from traffic_sign_detector.config import PipelineConfig
    from traffic_sign_detector.models.rec_pipeline import (
        RecognitionPipeline,
    )
    from traffic_sign_detector.utils.serialization import (
        write_results_file,
    )

    test_path = args.test_path.replace("\\", "/")
    src = "CNN proposals" if cnn_det is not None else "MSER proposals"
    print(f"\nrunning recognizer over {test_path} ({src}) ...")
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(
            mser=mser, no_sign_tol=args.no_sign_tol,
            rec_grows=tuple(float(g) for g in args.rec_grows.split(",")),
        ),
        classifier=result.classifier,
        cnn=cnn_det,
    )
    t0 = time.time()
    dets = pipe.run_directory(test_path, progress=True)
    print(f"{len(dets)} detections in {time.time() - t0:.1f}s; "
          f"writing {args.out}")
    write_results_file(args.out, dets)


if __name__ == "__main__":
    sys.exit(main())
