"""End-to-end detection smoke test on a real frame region (CPU-sized)."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from conftest import require_cv2

from traffic_sign_detector.config import MSERConfig, PipelineConfig
from traffic_sign_detector.models.detector import DetectionPipeline
from traffic_sign_detector.models.mean_masks import train_mean_masks


@pytest.fixture(scope="module")
def templates(train_frames_dir):
    return train_mean_masks(str(train_frames_dir))


def test_detect_sign_in_real_frame_region(templates, test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00601.jpg"))
    # 512x256 region containing the prohibicion sign GT (82,450)-(145,508)
    region = np.ascontiguousarray(img[384:640, 0:512])

    # mask-correlation scores are hypersensitive to box edges (a 2-3 px box
    # shift moves the reference's own score across the 0.55 line), so the
    # smoke test uses a slightly relaxed acceptance threshold
    cfg = PipelineConfig(
        mser=MSERConfig(delta=7, min_area=200, max_area=2000,
                        max_variation=1.0, max_regions=512),
        max_detections=64,
        batch_size=1,
        mask_corr_tol=0.4,
    )
    pipe = DetectionPipeline(cfg=cfg, templates=templates)
    dets = pipe.detect_frames(region[None], ["region.jpg"])
    assert dets, "no detections at all in a region with a clear sign"

    # GT sign in region coords: (82, 66) - (145, 124); type 1 (prohibicion)
    def iou(d):
        ix = max(0, min(d.x2, 145) - max(d.x1, 82))
        iy = max(0, min(d.y2, 124) - max(d.y1, 66))
        inter = ix * iy
        a = (d.x2 - d.x1) * (d.y2 - d.y1) + (145 - 82) * (124 - 66) - inter
        return inter / a if a > 0 else 0

    hits = [d for d in dets if iou(d) > 0.4]
    assert hits, f"sign not covered; got {[(d.x1,d.y1,d.x2,d.y2,d.class_id,d.score) for d in dets]}"
    assert any(d.class_id == 1 for d in hits)
    for d in dets:
        assert 0.0 <= d.score <= 1.0
        assert 1 <= d.class_id <= 6


def test_batch_padding_no_phantom_detections(templates, test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00601.jpg"))
    region = np.ascontiguousarray(img[384:640, 0:512])
    cfg = PipelineConfig(
        mser=MSERConfig(max_variation=1.0, max_regions=256),
        max_detections=32,
        batch_size=2,
    )
    pipe = DetectionPipeline(cfg=cfg, templates=templates)
    frames = np.stack([region, np.zeros_like(region)])
    dets = pipe.detect_frames(frames, ["real.jpg", "blank.jpg"])
    assert all(d.filename != "blank.jpg" for d in dets)


def test_run_directory_matches_detect_frames(templates, test_frames_dir, tmp_path):
    """The pipelined run_directory (one batch kept in flight, packed D2H)
    must produce exactly the per-batch detect_frames results, including the
    odd tail batch."""
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00601.jpg"))
    region = np.ascontiguousarray(img[384:640, 0:512])
    rng = np.random.default_rng(7)
    frames = [region, np.ascontiguousarray(region[::-1]), np.zeros_like(region)]
    names = []
    for i, fr in enumerate(frames):
        name = f"f{i}.jpg"
        cv2.imwrite(str(tmp_path / name), fr)
        names.append(name)

    cfg = PipelineConfig(
        mser=MSERConfig(max_variation=1.0, max_regions=128),
        max_detections=32,
        batch_size=2,  # 3 files -> one full batch + a padded tail batch
        mask_corr_tol=0.4,
    )
    pipe = DetectionPipeline(cfg=cfg, templates=templates)
    got = pipe.run_directory(str(tmp_path))

    want = []
    for i in range(0, 3, 2):
        chunk = frames[i : i + 2]
        cnames = names[i : i + 2]
        if len(chunk) < 2:
            chunk = chunk + [chunk[-1]]
            cnames = cnames + ["__pad__"]
        # decode roundtrip: compare against what run_directory actually read
        decoded = np.stack(
            [cv2.imread(str(tmp_path / n)) if n != "__pad__" else chunk[-1]
             for n in cnames]
        )
        dets = pipe.detect_frames(decoded, cnames)
        want.extend(d for d in dets if d.filename != "__pad__")

    key = lambda d: (d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id)
    assert sorted(map(key, got)) == sorted(map(key, want))
