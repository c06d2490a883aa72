"""Convert a float v3 checkpoint to the int8 serving artifact.

Usage:
    python scripts/quantize_cnn.py \
        [--params artifacts/cnn_detector/params.npz] \
        [--out artifacts/cnn_detector/params_int8.npz] \
        [--calib_dir ".../train_jpg"] [--calib_frames 32] \
        [--percentile 99.9]

Calibration frames default to the GTSDB training frames; per-tensor
activation scales only need a handful.  The emitted npz carries
``__quant__='int8'`` plus the source checkpoint's sha256 so bench/PARITY
can trace which float weights an int8 artifact came from; every loader
(`models/cnn_quant.py: load_detector`) auto-detects the tag.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from traffic_sign_detector.models.cnn_detector import (  # noqa: E402
    CNNDetectorConfig,
    init_params,
    load_params,
    saved_meta,
)
from traffic_sign_detector.models.cnn_quant import (  # noqa: E402
    quantize_v3,
    save_quant_params,
)

_DEF_TRAIN = "/root/reference/Deteción de Objetos/train_jpg"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params",
                    default="artifacts/cnn_detector/params.npz")
    ap.add_argument("--out",
                    default="artifacts/cnn_detector/params_int8.npz")
    ap.add_argument("--calib_dir", default=_DEF_TRAIN)
    ap.add_argument("--calib_frames", type=int, default=32)
    # 100 = max calibration.  99.9 measured catastrophic for detection:
    # the clipped activation tail IS the center-peak signal (peak |dP|
    # 0.136 vs 0.015; models/cnn_quant.py docstring)
    ap.add_argument("--percentile", type=float, default=100.0)
    ap.add_argument("--float_heads", action="store_true",
                    help="keep head convs in bf16 (trunk output stays int8 "
                         "in HBM; removes head weight-quant error)")
    args = ap.parse_args()

    meta = saved_meta(args.params)
    cfg = CNNDetectorConfig(**meta)
    if cfg.arch != "v3":
        raise SystemExit(f"int8 path implements arch v3, checkpoint is "
                         f"{cfg.arch!r}")
    params = load_params(args.params, init_params(0))
    sha = hashlib.sha256(open(args.params, "rb").read()).hexdigest()[:12]

    from traffic_sign_detector.data.images import (
        list_frame_files,
        load_frames_batch,
    )

    files = list_frame_files(args.calib_dir)[: args.calib_frames]
    if not files:
        raise SystemExit(f"no calibration frames in {args.calib_dir}")
    frames = load_frames_batch(args.calib_dir, files)
    # crop to a stride multiple (native GTSDB 1360x800 already is)
    h = frames.shape[1] // 16 * 16
    w = frames.shape[2] // 16 * 16
    frames = frames[:, :h, :w]
    print(f"calibrating on {len(files)} frames {frames.shape[1:]} "
          f"(percentile {args.percentile})")

    q = quantize_v3(params, frames, percentile=args.percentile,
                    float_heads=args.float_heads)
    save_quant_params(args.out, q, arch=cfg.arch,
                      score_threshold=cfg.score_threshold,
                      source_sha256=sha)
    size = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size:.2f} MB, source sha {sha})")


if __name__ == "__main__":
    main()
