"""Edge-case coverage: non-divisible CLAHE sizes, empty inputs, rounding."""

import numpy as np
import pytest

from traffic_sign_detector.ops.clahe import clahe_equalize
from traffic_sign_detector.ops.dedup import dedup_by_coords
from traffic_sign_detector.models.mean_masks import (
    mask_correlation_classify,
)


def test_clahe_non_divisible_size():
    rng = np.random.default_rng(30)
    img = rng.integers(0, 256, (50, 70), np.uint8)  # not divisible by 8
    out = np.asarray(clahe_equalize(img))
    assert out.shape == (50, 70)
    assert out.dtype == np.uint8
    # equalization must change a low-contrast image
    flat = np.full((50, 70), 100, np.uint8)
    flat[10:20, 10:20] = 110
    eq = np.asarray(clahe_equalize(flat))
    assert eq.max() > 110  # clipped redistribution stretches mildly


def test_dedup_all_invalid():
    crops = np.zeros((4, 25, 25, 3), np.uint8)
    boxes = np.zeros((4, 4), np.int32)
    _, _, alive = dedup_by_coords(crops, boxes, np.zeros(4, bool), 0.95)
    assert not np.asarray(alive).any()


def test_mask_classify_rejects_black_crops():
    # black crops have empty color masks -> every template scores 0
    crops = np.zeros((3, 25, 25, 3), np.uint8)
    red = np.ones((6, 625), np.float32)
    blue = np.ones((6, 625), np.float32)
    types, scores, accept = mask_correlation_classify(crops, red, blue, 0.55)
    assert (np.asarray(scores) == 0).all()
    assert not np.asarray(accept).any()


def test_mask_classify_score_rounding_boundary():
    # construct a crop mask covering exactly half a template: F1 = 2/3 -> 0.67
    red_t = np.zeros((6, 625), np.float32)
    red_t[0, :100] = 1.0
    blue_t = np.zeros((6, 625), np.float32)
    crop = np.zeros((1, 25, 25, 3), np.uint8)
    # paint 50 pixels pure red (BGR) in the first two rows
    flat = crop.reshape(1, 625, 3)
    flat[0, :50] = (0, 0, 255)
    types, scores, accept = mask_correlation_classify(
        crop.reshape(1, 25, 25, 3), red_t, blue_t, 0.55
    )
    assert float(np.asarray(scores)[0]) == pytest.approx(0.67)
    assert int(np.asarray(types)[0]) == 1
    assert bool(np.asarray(accept)[0])
