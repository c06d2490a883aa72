import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.ops.histogram import (
    correlation_matrix,
    hist_correlation,
    hs_histograms,
    minmax_normalize,
)


@pytest.fixture(scope="module")
def crops():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, size=(8, 25, 25, 3), dtype=np.uint8)


def _cv_hist(cv2, img):
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    h = cv2.calcHist([hsv], [0, 1], None, [50, 60], [0, 180, 0, 256])
    return h


def test_hs_histograms_exact(crops):
    cv2 = require_cv2()
    ours = np.asarray(hs_histograms(crops))
    for i in range(len(crops)):
        ref = _cv_hist(cv2, crops[i]).reshape(-1)
        np.testing.assert_array_equal(ours[i], ref)


def test_minmax_normalize_matches_cv(crops):
    cv2 = require_cv2()
    ours = np.asarray(minmax_normalize(np.asarray(hs_histograms(crops))))
    for i in range(len(crops)):
        h = _cv_hist(cv2, crops[i])
        ref = cv2.normalize(h, h, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX)
        np.testing.assert_allclose(ours[i], ref.reshape(-1), atol=1e-6)


def test_correlation_matches_cv(crops):
    cv2 = require_cv2()
    sims = np.asarray(hist_correlation(crops))
    norm = []
    for i in range(len(crops)):
        h = _cv_hist(cv2, crops[i])
        norm.append(cv2.normalize(h, h, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX))
    for i in range(len(crops)):
        for j in range(len(crops)):
            ref = cv2.compareHist(norm[i], norm[j], cv2.HISTCMP_CORREL)
            assert sims[i, j] == pytest.approx(ref, abs=1e-5)


def test_correlation_degenerate_rows():
    a = np.ones((2, 16), np.float32)  # zero variance
    b = np.random.default_rng(0).random((2, 16)).astype(np.float32)
    m = np.asarray(correlation_matrix(a, b))
    assert (m == 1.0).all()


def test_identical_crops_correlate_to_one(crops):
    sims = np.asarray(hist_correlation(crops))
    np.testing.assert_allclose(np.diag(sims), 1.0, atol=1e-5)
