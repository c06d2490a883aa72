#!/usr/bin/env python3
"""Regenerate the full-fidelity pipeline golden fixture.

Runs the shipped tuned detection config (downscale-2 sweep, 256 proposal
slots, mask_corr_tol 0.55) over the first 8 GTSDB test frames on the CPU
backend (the backend the test suite runs on) and pins the resulting
resultado-format lines to ``tests/fixtures/golden_pipeline_8f.txt``.

Run this ONLY when an intentional quality-affecting change lands; the
paired test (`tests/test_golden_pipeline.py`) exists so that *unintended*
kernel regressions fail CI.

Runs on the CPU backend (``JAX_PLATFORMS=cpu``), the backend the test
suite runs on; the producing backend is recorded in a ``.meta`` sidecar.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_FRAMES = [f"{600 + i:05d}.jpg" for i in range(8)]
DET_DIR = "/root/reference/Deteción de Objetos/test_alumnos_jpg"
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests",
    "fixtures",
    "golden_pipeline_8f.txt",
)


def golden_config():
    from traffic_sign_detector.config import MSERConfig, PipelineConfig

    return PipelineConfig(
        mser=MSERConfig(
            delta=7,
            min_area=200,
            max_area=2000,
            max_variation=1.0,
            downscale=2,
            max_regions=256,
        ),
        batch_size=4,
        mask_corr_tol=0.55,
    )


def run_golden_frames():
    import numpy as np

    from traffic_sign_detector.data.images import load_image_bgr
    from traffic_sign_detector.models.detector import DetectionPipeline
    from traffic_sign_detector.models.mean_masks import MeanMaskTemplates

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    templates = MeanMaskTemplates.load(os.path.join(repo, "artifacts", "mean_masks.npz"))
    pipe = DetectionPipeline(cfg=golden_config(), templates=templates)
    dets = []
    for i in range(0, len(GOLDEN_FRAMES), 4):
        chunk = GOLDEN_FRAMES[i : i + 4]
        frames = np.stack(
            [load_image_bgr(os.path.join(DET_DIR, f)) for f in chunk]
        )
        dets.extend(pipe.detect_frames(frames, chunk))
    return dets


def main() -> int:
    import jax

    from traffic_sign_detector.utils.serialization import (
        write_results_file,
    )

    dets = run_golden_frames()
    write_results_file(OUT, dets)
    with open(OUT + ".meta", "w") as fh:
        fh.write(f"backend={jax.devices()[0].platform}\n")
    print(f"wrote {len(dets)} detections to {OUT} "
          f"(backend={jax.devices()[0].platform})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
