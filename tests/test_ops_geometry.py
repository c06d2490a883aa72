import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.ops.geometry import (
    boxes_match_score,
    filter_and_grow_boxes,
    iou_matrix,
    pairwise_coord_similarity,
    sigmoid_distance_similarity,
)
from traffic_sign_detector.ops.resize import crop_and_resize
from traffic_sign_detector.eval.stats import (
    box_match_score as host_match_score,
)


def _ref_grow(window, percentage):
    """Host model of the reference's makeWindowBiggerOrDiscardFakeDetections."""
    x1, y1, w, h = window
    x2, y2 = x1 + w, y1 + h
    dw = w * (percentage - 1) * 0.5
    dh = h * (percentage - 1) * 0.5
    if not (0.8 < w / h < 1.20):
        return None
    x1 = x1 - dw if x1 - dw > 0 else 0
    y1 = y1 - dh if y1 - dh > 0 else 0
    x2 = x2 + dw if x2 + dw > 0 else 0
    y2 = y2 + dh if y2 + dh > 0 else 0
    return int(x1), int(y1), int(x2), int(y2)


def test_filter_and_grow_matches_reference_rule():
    rng = np.random.default_rng(1)
    n = 256
    boxes = np.stack(
        [
            rng.integers(0, 1300, n),
            rng.integers(0, 760, n),
            rng.integers(5, 120, n),
            rng.integers(5, 120, n),
        ],
        axis=-1,
    ).astype(np.int32)
    for grow in (1.30, 1.15):
        out, keep = filter_and_grow_boxes(boxes, np.ones(n, bool), grow)
        out, keep = np.asarray(out), np.asarray(keep)
        for i in range(n):
            expect = _ref_grow(tuple(boxes[i]), grow)
            if expect is None:
                assert not keep[i]
            else:
                assert keep[i]
                assert tuple(out[i]) == expect


def test_sigmoid_similarity_matches_host():
    for d, (ax, ay, bx, by) in [
        (0, (3, 4, 3, 4)),
        (1, (0, 0, 1, 0)),
        (25, (0, 0, 25, 0)),
        (100, (0, 0, 100, 0)),
    ]:
        ours = float(sigmoid_distance_similarity(np.array(float(d))))
        from traffic_sign_detector.eval.stats import (
            sigmoid_distance_similarity as host_sim,
        )

        assert ours == pytest.approx(host_sim(ax, ay, bx, by), rel=1e-5)


def test_pairwise_similarity_consistency():
    boxes = np.array(
        [[10, 10, 50, 50], [12, 11, 52, 49], [400, 300, 440, 350]], np.int32
    )
    sims = np.asarray(pairwise_coord_similarity(boxes))
    assert sims.shape == (3, 3)
    np.testing.assert_allclose(np.diag(sims), 1.0, atol=1e-6)
    assert sims[0, 1] == pytest.approx(
        host_match_score(tuple(boxes[0]), tuple(boxes[1])), rel=1e-5
    )
    assert sims[0, 2] < 0.2
    full = np.asarray(boxes_match_score(boxes, boxes))
    np.testing.assert_allclose(full, sims, atol=1e-6)


def test_iou_matrix_matches_textbook():
    a = np.array([[0, 0, 9, 9]], np.int32)  # 10x10 inclusive
    b = np.array([[0, 0, 9, 9], [5, 5, 14, 14], [20, 20, 29, 29]], np.int32)
    m = np.asarray(iou_matrix(a, b))[0]
    assert m[0] == pytest.approx(1.0)
    assert m[1] == pytest.approx(25 / (100 + 100 - 25))
    assert m[2] == 0.0


def test_crop_and_resize_vs_opencv(test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00600.jpg"))
    rng = np.random.default_rng(2)
    boxes = []
    for _ in range(64):
        x1 = int(rng.integers(0, 1300))
        y1 = int(rng.integers(0, 740))
        w = int(rng.integers(8, 60))
        h = int(rng.integers(8, 60))
        boxes.append((x1, y1, min(x1 + w, 1360), min(y1 + h, 800)))
    boxes = np.array(boxes, np.int32)

    for size in (25, 32):
        ours = np.asarray(crop_and_resize(img, boxes, size)).astype(np.int32)
        exact = 0
        for i, (x1, y1, x2, y2) in enumerate(boxes):
            ref = cv2.resize(img[y1:y2, x1:x2], (size, size)).astype(np.int32)
            diff = np.abs(ours[i] - ref)
            assert diff.max() <= 3, (i, diff.max())
            exact += (diff <= 1).mean()
        assert exact / len(boxes) > 0.99


def test_crop_and_resize_out_of_bounds_clamps(test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00600.jpg"))
    # box extends past the right/bottom edge: numpy slicing clamps silently
    boxes = np.array([[1340, 780, 1400, 860]], np.int32)
    ours = np.asarray(crop_and_resize(img, boxes, 25)).astype(np.int32)
    ref = cv2.resize(img[780:860, 1340:1400], (25, 25)).astype(np.int32)
    assert np.abs(ours[0] - ref).max() <= 3
