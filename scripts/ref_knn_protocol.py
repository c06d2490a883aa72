#!/usr/bin/env python3
"""Run the REFERENCE's own recognition recipe over the full test protocol.

The repo's KNN quality (F1 0.46 / AP 0.275 on the
MSER-proposal test path) had no reference-side counterpart, because the
reference ships no test-set path at all — `REC/main.py:64` calls a
commented-out ``source.test(...)`` that DOES NOT EXIST in its source.py
(only ``testValidation`` does).  This script supplies the missing glue and
nothing else: it copies the reference's unmodified ``source.py`` /
``constants.py`` into a temp dir, drives ITS functions end to end —
``initializeMSER`` -> ``loadTrainData`` (negative mining incl. the
MSERTrain.val cache) -> ``calculateDescriptors`` -> ``createClassifiers`` /
``fitClassifiers`` -> per-test-frame ``MSERTrafficSignDetector`` ->
``predictProbability`` — and writes the resulting detections in the
resultado.txt protocol, scored with our verified scorer (eval/ap.py matches
the instructor's evaluar_resultados.py to 1e-5).

Feature notes:
* ``GRAY`` descriptors only: this container's cv2 5.0 removed
  ``HOGDescriptor`` (see tests/test_ops_hog.py), so the reference's HOG
  path cannot execute here — recorded in PARITY.md.
* Test frames are passed to the detector as BGR and each crop grayed
  afterwards — exactly the reference's own negative-mining flow
  (``REC/source.py:384-388``), producing the 1024-dim ravel()
  descriptors its classifiers are trained on.
* Scores: the reference's predict paths return labels only (KNN) or an
  argmax class (LDABAYES) with no calibrated score, so detections carry
  score 1.0 — exactly like the instructor's own practica-2 golden file
  (``resultado_práctica2_jmbuena.txt``, 178 rows, almost all score 1.0).

Usage:  python scripts/ref_knn_protocol.py [--classifiers KNN,LDABAYES]
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

REF = "/root/reference/Reconocimiento de Objetos"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--classifiers", default="KNN,LDABAYES")
    ap.add_argument("--out_dir", default="/tmp/ref_knn")
    ap.add_argument("--limit", type=int, default=None,
                    help="limit test frames (debugging)")
    args = ap.parse_args()

    import matplotlib

    matplotlib.use("Agg")

    # stable workdir so the reference's MSERTrain.val mining cache
    # (REC/source.py:381-395) is reused across runs, same as upstream
    work = "/tmp/refknn_work"
    os.makedirs(work, exist_ok=True)
    for f in ("source.py", "constants.py"):
        shutil.copy(os.path.join(REF, f), work)
    for d in ("train_jpg", "test_alumnos_jpg"):
        if not os.path.exists(os.path.join(work, d)):
            os.symlink(os.path.join(REF, d), os.path.join(work, d))
    os.chdir(work)
    sys.path.insert(0, work)

    import cv2

    import constants
    import source

    constants.TRAIN_PATH = "train_jpg"
    constants.TRAIN_PATH_REAL_RESULTS = "train_jpg/gt.txt"

    mser = source.initializeMSER((7, 200, 2000, 1))
    fd = source.initializeFeatureDescriptor("GRAY")

    t0 = time.time()
    print("loading reference train data (incl. MSER negative mining)...")
    train_data, _train_images = source.loadTrainData(mser)
    print(f"train data loaded in {time.time() - t0:.0f}s: "
          + ", ".join(f"{k}:{len(v)}" for k, v in train_data.items()))
    train_desc = source.calculateDescriptors(train_data, fd)

    # test proposals via the reference's own detector on GRAY frames
    test_dir = "test_alumnos_jpg"
    files = sorted(f for f in os.listdir(test_dir) if f.endswith(".jpg"))
    if args.limit:
        files = files[: args.limit]
    det_descs = []
    t0 = time.time()
    for i, fname in enumerate(files):
        img = cv2.imread(os.path.join(test_dir, fname))
        # the reference feeds BGR frames and grays each crop afterwards
        # (its negative-mining pass, REC/source.py:384-388) — mirror that
        for crop, coords, f, _lbl in source.MSERTrafficSignDetector(
                img, mser, fname):
            gray_crop = cv2.cvtColor(crop, cv2.COLOR_BGR2GRAY)
            det_descs.append(
                (source.computeDescriptors(gray_crop, fd), coords, f, 0))
        if (i + 1) % 30 == 0:
            print(f"  {i + 1}/{len(files)} test frames "
                  f"({len(det_descs)} proposals)")
    print(f"test proposals: {len(det_descs)} in {time.time() - t0:.0f}s")

    os.makedirs(args.out_dir, exist_ok=True)
    for clf_name in args.classifiers.split(","):
        clf_name = clf_name.strip().upper()
        print(f"\n=== reference {'GRAY'}_LDA_{clf_name} ===")
        classifiers = source.createClassifiers(clf_name)
        reducer, _, _ = source.fitClassifiers(classifiers, "LDA", train_desc)
        pred, _true = source.predictProbability(
            classifiers, reducer, det_descs, 0.5)
        out_path = os.path.join(args.out_dir,
                                f"resultado_ref_gray_lda_{clf_name.lower()}"
                                ".txt")
        n_kept = 0
        with open(out_path, "w", encoding="utf-8") as fh:
            for (desc, coords, fname, _l), cls in zip(det_descs, pred):
                cls = int(cls)
                if cls <= 0:
                    continue
                x1, y1, x2, y2 = coords
                fh.write(f"{fname};{x1};{y1};{x2};{y2};{cls};1.0\n")
                n_kept += 1
        print(f"{n_kept} detections -> {out_path}")
        # score with our verified scorer in a clean CPU process (this
        # process must stay jax-free so it cannot touch the device)
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "evaluate_results.py"),
             "--test_path", os.path.join(REF, "test_alumnos_jpg"),
             "--detections_file", out_path, "--no_golden"],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO)
        print(r.stdout.strip()[-2000:])
        if r.returncode:
            print(r.stderr[-2000:])


if __name__ == "__main__":
    main()
