"""Mean-mask recognizer: template training + scoring vs a cv2 oracle."""

import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.constants import SUPERTYPE_CLASS_DIRS
from traffic_sign_detector.models.mean_masks import (
    MeanMaskTemplates,
    mask_correlation_classify,
    train_mean_masks,
)


@pytest.fixture(scope="module")
def templates(train_frames_dir):
    return train_mean_masks(str(train_frames_dir))


def _oracle_templates(cv2, train_dir):
    """cv2 rendition of the reference's calculateMeanMasks (sorted order)."""
    import os

    reds, blues = [], []
    for dirs in SUPERTYPE_CLASS_DIRS:
        mean = None
        for d in dirs:
            droot = os.path.join(train_dir, d)
            if not os.path.isdir(droot):
                continue
            for f in sorted(os.listdir(droot)):
                img = cv2.resize(cv2.imread(os.path.join(droot, f)), (25, 25))
                if mean is None:
                    mean = cv2.addWeighted(img, 1, np.zeros_like(img), 0, 0.0)
                else:
                    mean = cv2.addWeighted(img, 0.5, mean, 0.5, 0.0)
        hsv = cv2.cvtColor(mean, cv2.COLOR_BGR2HSV)
        red = cv2.add(
            cv2.inRange(hsv, np.array([0, 50, 10]), np.array([10, 255, 255])),
            cv2.inRange(hsv, np.array([160, 50, 10]), np.array([179, 255, 255])),
        )
        blue = cv2.inRange(hsv, np.array([90, 70, 10]), np.array([128, 255, 255]))
        reds.append((red.reshape(-1) > 0).astype(np.float32))
        blues.append((blue.reshape(-1) > 0).astype(np.float32))
    return np.stack(reds), np.stack(blues)


def test_templates_match_cv_oracle(templates, train_frames_dir):
    cv2 = require_cv2()
    ref_red, ref_blue = _oracle_templates(cv2, str(train_frames_dir))
    # resize rounding can flip a few boundary pixels through the 853-crop
    # blend; demand high agreement rather than bit equality
    assert (templates.red == ref_red).mean() > 0.95
    assert (templates.blue == ref_blue).mean() > 0.95


def test_template_shapes_and_sanity(templates):
    assert templates.red.shape == (6, 625)
    assert templates.blue.shape == (6, 625)
    # red-ring types must have red support; the mandatory (blue) type must
    # have blue support
    assert templates.red[0].sum() > 20  # prohibicion
    assert templates.red[2].sum() > 20  # stop
    assert templates.blue[5].sum() > 20  # direccionObligatoria


def test_save_load_roundtrip(tmp_path, templates):
    p = str(tmp_path / "tmpl.npz")
    templates.save(p)
    loaded = MeanMaskTemplates.load(p)
    np.testing.assert_array_equal(loaded.red, templates.red)
    np.testing.assert_array_equal(loaded.blue, templates.blue)


def test_classify_training_crops(templates, train_frames_dir):
    """Crops of real signs should classify to their own super-type."""
    cv2 = require_cv2()
    import os

    cases = [("14", 3), ("38", 6), ("13", 5)]  # stop, mandatory, yield
    crops, expected = [], []
    for d, st in cases:
        droot = os.path.join(str(train_frames_dir), d)
        files = sorted(os.listdir(droot))[:5]
        for f in files:
            img = cv2.resize(cv2.imread(os.path.join(droot, f)), (25, 25))
            crops.append(img)
            expected.append(st)
    crops = np.stack(crops)
    types, scores, accept = mask_correlation_classify(
        crops, templates.red, templates.blue
    )
    types = np.asarray(types)
    accept = np.asarray(accept)
    correct = (types == np.array(expected)) & accept
    assert correct.mean() >= 0.6  # the reference recognizer is itself weak


def test_scores_rounded_and_bounded(templates):
    rng = np.random.default_rng(11)
    crops = rng.integers(0, 256, (16, 25, 25, 3), np.uint8)
    _, scores, _ = mask_correlation_classify(crops, templates.red, templates.blue)
    scores = np.asarray(scores)
    assert (scores >= 0).all() and (scores <= 1).all()
    np.testing.assert_allclose(scores, np.round(scores * 100) / 100, atol=1e-6)
