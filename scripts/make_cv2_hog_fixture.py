#!/usr/bin/env python3
"""Generate the cv2-HOG golden fixture (run OFFLINE with OpenCV 4.x).

This container ships cv2 5.0 without ``HOGDescriptor`` and has zero
network egress, so true OpenCV-binary HOG parity cannot be asserted here
(tests/test_ops_hog.py pins the algorithm with a hand-derived analytic
oracle instead — see the note there).  To upgrade that to binary parity:
run THIS script anywhere cv2 4.x is available, then drop the produced
``cv2_hog_golden.npz`` into ``tests/fixtures/`` —
``test_matches_cv2_golden_fixture`` picks it up automatically (it skips
while the file is absent).

The fixture inputs are deterministic (PCG64 seed 20240814), so the file
is reproducible bit-for-bit from any cv2 4.x build that shares OpenCV's
reference C++ HOG (all official builds do):

    python scripts/make_cv2_hog_fixture.py --out cv2_hog_golden.npz

Reference HOG configuration (the reference project's
``Reconocimiento de Objetos/constants.py:14``): window 32x32, block
16x16, stride 8x8, cell 8x8, 9 bins, signed gradients.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SEED = 20240814
N_CROPS = 32


def fixture_inputs() -> np.ndarray:
    """The exact [N, 32, 32] uint8 inputs the parity test replays."""
    rng = np.random.default_rng(SEED)
    crops = rng.integers(0, 256, (N_CROPS, 32, 32), np.uint8)
    # a few structured cases beyond noise: flat, ramps, edge, disc
    crops[0] = 128
    crops[1] = np.tile(np.arange(32, dtype=np.uint8) * 8, (32, 1))
    crops[2] = crops[1].T
    crops[3, :, 16:] = 255
    crops[3, :, :16] = 0
    yy, xx = np.mgrid[0:32, 0:32]
    crops[4] = np.where((yy - 16) ** 2 + (xx - 16) ** 2 < 100, 220, 30)
    return crops


def native_descriptors(crops) -> "np.ndarray":
    """True cv::HOGDescriptor output via the SYSTEM OpenCV 4.6 C++ API.

    pip is unreachable (zero egress — attempt recorded in PARITY.md r5)
    and python cv2 is 5.0, but the container ships OpenCV 4.6 C++ dev
    libraries: runtime/hog_golden.cpp computes the reference-exact
    descriptors (REC/constants.py:14 config) out of process."""
    import subprocess
    import tempfile

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(here, "traffic_sign_detector", "runtime",
                       "hog_golden.cpp")
    exe = os.path.join(tempfile.mkdtemp(), "hog_golden")
    subprocess.run(
        ["g++", "-O2", "-o", exe, src, "-I/usr/include/opencv4",
         "-lopencv_objdetect", "-lopencv_core", "-lopencv_imgproc"],
        check=True)
    payload = np.int32(len(crops)).tobytes() + crops.tobytes()
    r = subprocess.run([exe], input=payload, stdout=subprocess.PIPE,
                       check=True)
    return np.frombuffer(r.stdout, np.float32).reshape(len(crops), 324)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="cv2_hog_golden.npz")
    ap.add_argument("--native", action="store_true",
                    help="use the system OpenCV 4.6 C++ HOGDescriptor "
                         "(runtime/hog_golden.cpp) instead of python cv2")
    args = ap.parse_args()

    crops = fixture_inputs()
    if args.native:
        desc = native_descriptors(crops)
        assert desc.shape == (N_CROPS, 324), desc.shape
        np.savez_compressed(args.out, crops=crops, descriptors=desc,
                            cv2_version=np.array("4.6.0-system-cpp"))
        print(f"wrote {args.out}: {desc.shape} descriptors from system "
              "OpenCV 4.6 C++")
        return 0

    import cv2

    if not hasattr(cv2, "HOGDescriptor"):
        print(f"cv2 {cv2.__version__} lacks HOGDescriptor — run this with "
              "OpenCV 4.x (or use --native)")
        return 1
    hog = cv2.HOGDescriptor(
        (32, 32), (16, 16), (8, 8), (8, 8), 9,
        1, -1.0, 0, 0.2, False, 64, True,  # signedGradient=True
    )
    crops = fixture_inputs()
    desc = np.stack([hog.compute(c).reshape(-1) for c in crops])
    assert desc.shape == (N_CROPS, 324), desc.shape
    np.savez_compressed(args.out, crops=crops, descriptors=desc,
                        cv2_version=np.array(cv2.__version__))
    print(f"wrote {args.out}: {desc.shape} descriptors from cv2 "
          f"{cv2.__version__}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
