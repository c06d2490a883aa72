#!/usr/bin/env python3
"""Operating-point sweep for a trained CNN detector checkpoint.

    python scripts/cnn_threshold_sweep.py --params /tmp/cnn_slim/params.npz \
        --arch slim [--thresholds 0.2,0.3,0.35,0.45,0.5,0.6]

Runs ONE low-threshold inference pass over the full test set, then
re-filters the detection list at each threshold and scores it with the
parity stats engine + PASCAL AP — the same protocol as the PARITY.md
operating-point table.

``--input_scale 1080p`` measures quality AT the north-star operating
point: test frames are bilinearly scaled 1360x800 -> 1920x1088 on device
(the resolution the fps headline is measured at), the detector runs on the
scaled frames, and its boxes are mapped back to native coordinates before
scoring — so both the stats engine's pixel-distance matcher and the PASCAL
AP stay in the reference's native coordinate space (protocol:
``Reconocimiento de Objetos/evaluar_resultados.py:199-320``).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DET_DATA = "/root/reference/Deteción de Objetos"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="artifacts/cnn_detector/params.npz")
    ap.add_argument("--arch", default=None,
                    help="override the arch tag stored in the npz")
    ap.add_argument("--test_path",
                    default=os.path.join(DET_DATA, "test_alumnos_jpg"))
    ap.add_argument("--thresholds", default="0.2,0.3,0.35,0.4,0.45,0.5,0.6")
    ap.add_argument("--eval_batch", type=int, default=8)
    ap.add_argument("--input_scale", default="native",
                    choices=["native", "1080p"])
    ap.add_argument("--upscale", type=float, default=1.0,
                    help="score the PRODUCT upscaled-inference path "
                    "(CNNDetector upscale=s): on-device bilinear scale "
                    "fused into the detect jit, boxes already native — "
                    "unlike --input_scale 1080p's manual protocol")
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from traffic_sign_detector.data.images import (
        list_frame_files, load_image_bgr)
    from traffic_sign_detector.eval.ap import score_detection_files
    from traffic_sign_detector.eval.stats import (
        compute_detection_statistics)
    from traffic_sign_detector.models import cnn_detector as cd
    from traffic_sign_detector.utils.serialization import (
        write_results_file)

    from traffic_sign_detector.models.cnn_quant import (
        load_detector, saved_quant)

    arch = args.arch or cd.saved_arch(args.params) or "base"
    cfg = cd.CNNDetectorConfig(score_threshold=0.1, arch=arch)
    # float or int8, by __quant__ tag; --upscale rides the product path
    det = load_detector(args.params, cfg, upscale=args.upscale)
    print(f"arch {arch} (quant {saved_quant(args.params)}), "
          f"input_scale {args.input_scale}, upscale {args.upscale:g}")

    hd = args.input_scale == "1080p"
    if hd:
        @jax.jit
        def _upscale(frames_u8):
            b = frames_u8.shape[0]
            out = jax.image.resize(frames_u8.astype(jnp.float32),
                                   (b, 1088, 1920, 3), "bilinear")
            return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    files = list_frame_files(args.test_path)
    dets = []
    t0 = time.time()
    for i in range(0, len(files), args.eval_batch):
        chunk = files[i:i + args.eval_batch]
        frames = np.stack([load_image_bgr(os.path.join(args.test_path, f))
                           for f in chunk])
        if hd:
            sy = 1088.0 / frames.shape[1]
            sx = 1920.0 / frames.shape[2]
            native_hw = frames.shape[1:3]
            frames = np.asarray(_upscale(jnp.asarray(frames)))
            for d in det.detect_frames(frames, chunk, orig_hw=(1088, 1920)):
                dets.append(dataclasses.replace(
                    d,
                    x1=int(np.clip(round(d.x1 / sx), 0, native_hw[1] - 1)),
                    x2=int(np.clip(round(d.x2 / sx), 0, native_hw[1] - 1)),
                    y1=int(np.clip(round(d.y1 / sy), 0, native_hw[0] - 1)),
                    y2=int(np.clip(round(d.y2 / sy), 0, native_hw[0] - 1))))
        else:
            dets.extend(det.detect_frames(frames, chunk,
                                          orig_hw=frames.shape[1:3]))
    print(f"{len(dets)} detections at thr 0.1 over {len(files)} frames "
          f"({time.time() - t0:.1f}s)")

    gt_path = os.path.join(args.test_path, "gt.txt")
    print(f"{'thr':>5} {'n':>4} {'P':>5} {'R':>5} {'F1':>5} {'AP':>7}")
    for thr in [float(x) for x in args.thresholds.split(",")]:
        kept = [d for d in dets if d.score >= thr]
        stats = compute_detection_statistics(kept, gt_path)
        t = stats.total
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as f:
            path = f.name
        write_results_file(path, kept)
        ap_res = score_detection_files(path, gt_path)
        os.unlink(path)

        def _f(v):
            return f"{v:5.2f}" if isinstance(v, float) else f"{v:>5}"

        print(f"{thr:5.2f} {len(kept):4d} {_f(t.precision)} {_f(t.recall)} "
              f"{_f(t.f1)} {ap_res['ap']:7.4f}")


if __name__ == "__main__":
    main()
