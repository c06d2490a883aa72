"""Oracle tests: color/preprocessing kernels vs OpenCV on real frames."""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.ops.blur import gaussian_blur_3x3
from traffic_sign_detector.ops.clahe import clahe_equalize
from traffic_sign_detector.ops.color import (
    bgr_to_gray,
    bgr_to_hsv,
    color_mask,
    gamma_correct,
    gamma_lut,
)
from traffic_sign_detector.ops.preprocess import enhance_contrast


@pytest.fixture(scope="module")
def frame(test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00600.jpg"))
    assert img is not None
    return img


@pytest.fixture(scope="module")
def random_bgr():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)


def test_bgr_to_gray_exact(frame, random_bgr):
    cv2 = require_cv2()
    for img in (frame, random_bgr):
        ours = np.asarray(bgr_to_gray(img))
        theirs = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(ours, theirs)


def test_bgr_to_hsv_exact(frame, random_bgr):
    cv2 = require_cv2()
    for img in (frame, random_bgr):
        ours = np.asarray(bgr_to_hsv(img))
        theirs = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        np.testing.assert_array_equal(ours, theirs)


def test_color_masks_exact(frame, random_bgr):
    cv2 = require_cv2()
    for img in (frame, random_bgr):
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        red = cv2.add(
            cv2.inRange(hsv, np.array([0, 50, 10]), np.array([10, 255, 255])),
            cv2.inRange(hsv, np.array([160, 50, 10]), np.array([179, 255, 255])),
        )
        blue = cv2.inRange(hsv, np.array([90, 70, 10]), np.array([128, 255, 255]))
        np.testing.assert_array_equal(np.asarray(color_mask(img, "r")), red)
        np.testing.assert_array_equal(np.asarray(color_mask(img, "b")), blue)


def test_gamma_lut_matches_reference_table():
    table = np.array(
        [((i / 255) ** (1 / 2)) * 255 for i in range(256)], np.uint8
    )
    np.testing.assert_array_equal(gamma_lut(2.0), table)


def test_gamma_correct_all_256_inputs_match_table():
    """The gamma=2 sqrt fast path must be bit-exact vs the LUT on every
    possible uint8 input (and the generic threshold path on another gamma)."""
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        np.asarray(gamma_correct(x, 2.0)), gamma_lut(2.0)[x]
    )
    np.testing.assert_array_equal(
        np.asarray(gamma_correct(x, 1.5)), gamma_lut(1.5)[x]
    )


@pytest.mark.slow
def test_gamma_correct_exact(frame):
    cv2 = require_cv2()
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    table = np.array([((i / 255) ** 0.5) * 255 for i in range(256)], np.uint8)
    np.testing.assert_array_equal(
        np.asarray(gamma_correct(gray, 2.0)), cv2.LUT(gray, table)
    )


def test_gaussian_blur_exact(frame, random_bgr):
    cv2 = require_cv2()
    for img in (
        cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
        cv2.cvtColor(random_bgr, cv2.COLOR_BGR2GRAY),
    ):
        ours = np.asarray(gaussian_blur_3x3(img))
        theirs = cv2.GaussianBlur(img, (3, 3), 0)
        np.testing.assert_array_equal(ours, theirs)


def test_clahe_close_to_opencv_crop(frame):
    """Fast-lane CLAHE oracle on a 256x256 crop (the full-frame variants
    below are slow-marked; this keeps cv2 parity in the inner loop)."""
    cv2 = require_cv2()
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[:256, :256]
    ours = np.asarray(clahe_equalize(gray)).astype(np.int32)
    theirs = cv2.createCLAHE(clipLimit=2).apply(gray).astype(np.int32)
    diff = np.abs(ours - theirs)
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


@pytest.mark.slow  # full-frame oracle, ~20-95 s on CPU
def test_clahe_close_to_opencv(frame):
    cv2 = require_cv2()
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    ours = np.asarray(clahe_equalize(gray)).astype(np.int32)
    theirs = cv2.createCLAHE(clipLimit=2).apply(gray).astype(np.int32)
    diff = np.abs(ours - theirs)
    # interpolation rounding may differ by 1 count on a tiny pixel fraction
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


def test_clahe_pallas_histogram_exact(fixtures_dir):
    """Tile histograms == the retired histogram kernel's recorded output
    (tests/fixtures/kernel_fixtures.npz), bit for bit."""
    from traffic_sign_detector.ops.clahe import _tile_histograms

    fix = np.load(fixtures_dir / "kernel_fixtures.npz")
    for tag in ("noise", "scene"):
        x = jnp.asarray(fix[f"clahe_{tag}_in"])
        np.testing.assert_array_equal(np.asarray(_tile_histograms(x, 8)),
                                      fix[f"clahe_{tag}_hist"], err_msg=tag)


@pytest.mark.parametrize("tag", ["noise", "scene"])
def test_clahe_matches_apply_kernel_fixture(fixtures_dir, tag):
    """Full CLAHE vs the retired LUT-apply kernel's recorded output: that
    kernel blended the LUTs in another float order, so rint may flip by one
    gray level on a tiny pixel fraction — the same bound the cv2 oracle
    tests use."""
    fix = np.load(fixtures_dir / "kernel_fixtures.npz")
    ours = np.asarray(clahe_equalize(jnp.asarray(fix[f"clahe_{tag}_in"])))
    diff = np.abs(ours.astype(np.int32) - fix[f"clahe_{tag}_out"])
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


@pytest.mark.slow  # full-frame oracle, ~20-95 s on CPU
def test_enhance_contrast_close_to_opencv(frame):
    cv2 = require_cv2()
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    eq = cv2.createCLAHE(clipLimit=2).apply(gray)
    blur = cv2.GaussianBlur(eq, (3, 3), 0)
    table = np.array([((i / 255) ** 0.5) * 255 for i in range(256)], np.uint8)
    theirs = cv2.LUT(blur, table).astype(np.int32)
    ours = np.asarray(enhance_contrast(frame)).astype(np.int32)
    diff = np.abs(ours - theirs)
    # A +-1 CLAHE rounding difference passes through the gamma LUT, whose
    # slope reaches ~8 near black, so rare pixels can differ by a few counts.
    assert diff.max() <= 8
    assert (diff == 0).mean() > 0.99
    assert (diff <= 1).mean() > 0.9999


def test_batched_shapes(random_bgr):
    batch = np.stack([random_bgr] * 3)
    assert np.asarray(bgr_to_hsv(batch)).shape == (3, 64, 64, 3)
    gray = np.asarray(bgr_to_gray(batch))
    assert gray.shape == (3, 64, 64)
    assert np.asarray(clahe_equalize(gray)).shape == (3, 64, 64)
    assert np.asarray(gaussian_blur_3x3(gray)).shape == (3, 64, 64)


def test_hsv_div_arithmetic_matches_tables():
    """The inline f32-division HSV constants must equal the OpenCV
    fixed-point tables for every possible uint8 input (the gather-free
    reformulation's exactness proof, ops/color.py)."""
    import numpy as np

    from traffic_sign_detector.ops.color import (
        _HSV_SHIFT,
        _hdiv_table,
        _sdiv_table,
    )

    x = np.arange(256, dtype=np.float32)
    sdiv = np.where(
        x > 0, np.rint(float(255 << _HSV_SHIFT) / np.maximum(x, 1.0)), 0.0
    ).astype(np.int32)
    hdiv = np.where(
        x > 0,
        np.rint((float(180 << _HSV_SHIFT) / 6.0) / np.maximum(x, 1.0)),
        0.0,
    ).astype(np.int32)
    np.testing.assert_array_equal(sdiv, _sdiv_table())
    np.testing.assert_array_equal(hdiv, _hdiv_table())
