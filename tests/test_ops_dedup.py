"""Dedup outcome parity vs a host oracle implementing the reference fold.

The oracle reproduces the sequential fold semantics exactly (newcomer always
appended; kept item deleted when similarity >= 0.8823*tol; merge band blends
pixels 50/50 and integer-averages coords).  Our vectorized version matches
the survivor set whenever merges don't flip later comparisons; these tests
use controlled inputs plus a statistical bound on real-frame proposals.
"""

import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.constants import DEDUP_MERGE_BAND
from traffic_sign_detector.ops.dedup import (
    dedup_by_coords,
    dedup_by_histogram,
)
from traffic_sign_detector.eval.stats import box_match_score


def _oracle_coord_fold(boxes, tol):
    """Reference cleanDuplicatedDetections with coordinate similarity."""
    kept: list[np.ndarray] = []
    for box in boxes:
        box = box.copy()
        deletions = []
        for k in kept:
            sim = box_match_score(tuple(box), tuple(k))
            if sim > tol:
                deletions.append(k)
            elif DEDUP_MERGE_BAND * tol <= sim <= tol:
                box = (box + k) // 2
                deletions.append(k)
        for d in deletions:
            kept = [k for k in kept if not np.array_equal(k, d)]
        kept.append(box)
    return kept


def test_coord_dedup_simple_duplicates():
    boxes = np.array(
        [
            [100, 100, 150, 150],
            [101, 100, 151, 151],  # near-exact duplicate of 0 -> kills it
            [400, 300, 460, 360],
            [402, 301, 461, 361],  # duplicate of 2
            [800, 200, 840, 240],  # isolated
        ],
        np.int32,
    )
    n = len(boxes)
    crops = np.zeros((n, 25, 25, 3), np.uint8)
    _, new_boxes, alive = dedup_by_coords(crops, boxes, np.ones(n, bool), 0.95)
    alive = np.asarray(alive)
    assert alive.tolist() == [False, True, False, True, True]

    oracle = _oracle_coord_fold(list(boxes), 0.95)
    ours = np.asarray(new_boxes)[alive]
    assert len(oracle) == alive.sum()
    for ob, ref in zip(ours, sorted(map(tuple, oracle))):
        pass  # same count; contents compared below
    assert sorted(map(tuple, ours.tolist())) == sorted(
        tuple(int(v) for v in o) for o in oracle
    )


def test_coord_dedup_merge_band():
    # construct a pair whose similarity lands inside [0.8823*tol, tol]
    base = np.array([100, 100, 160, 160], np.int32)
    tol = 0.95
    hit = None
    for off in range(1, 40):
        cand = base + np.array([off, 0, off, 0], np.int32)
        s = box_match_score(tuple(cand), tuple(base))
        if DEDUP_MERGE_BAND * tol <= s <= tol:
            hit = cand
            break
    assert hit is not None, "no offset landed in the merge band"
    boxes = np.stack([base, hit])
    crops = np.zeros((2, 25, 25, 3), np.uint8)
    _, new_boxes, alive = dedup_by_coords(crops, boxes, np.ones(2, bool), tol)
    alive = np.asarray(alive)
    assert alive.tolist() == [False, True]
    merged = np.asarray(new_boxes)[1]
    expect = (base + hit) // 2
    np.testing.assert_array_equal(merged, expect)


def test_coord_dedup_respects_validity():
    boxes = np.array([[10, 10, 60, 60], [10, 10, 60, 60]], np.int32)
    crops = np.zeros((2, 25, 25, 3), np.uint8)
    valid = np.array([True, False])
    _, _, alive = dedup_by_coords(crops, boxes, valid, 0.95)
    # the invalid duplicate must not kill the valid one
    assert np.asarray(alive).tolist() == [True, False]


def test_hist_dedup_identical_crops(test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00600.jpg"))
    crop_a = img[100:150, 100:150]
    crop_a = cv2.resize(crop_a, (25, 25))
    crop_b = cv2.resize(img[400:460, 700:760], (25, 25))
    crops = np.stack([crop_a, crop_a.copy(), crop_b])
    boxes = np.array(
        [[100, 100, 150, 150], [500, 100, 550, 150], [700, 400, 760, 460]],
        np.int32,
    )
    _, _, alive = dedup_by_histogram(crops, boxes, np.ones(3, bool), 0.85)
    # identical-content crops dedup regardless of coordinates
    assert np.asarray(alive).tolist() == [False, True, True]


def test_oracle_statistical_agreement_random_boxes():
    rng = np.random.default_rng(7)
    n = 64
    centers = rng.integers(100, 700, size=(n, 2))
    sizes = rng.integers(20, 60, size=(n, 1))
    jitter = rng.integers(-3, 4, size=(n, 2))
    boxes = np.concatenate(
        [centers + jitter, centers + sizes + jitter], axis=1
    ).astype(np.int32)
    crops = np.zeros((n, 25, 25, 3), np.uint8)
    _, _, alive = dedup_by_coords(crops, boxes, np.ones(n, bool), 0.95)
    oracle = _oracle_coord_fold(list(boxes), 0.95)
    # survivor counts must agree closely (merge-chain drift is second-order)
    assert abs(int(np.asarray(alive).sum()) - len(oracle)) <= max(2, n // 20)
