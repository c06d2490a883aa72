"""CCL kernel correctness vs OpenCV connectedComponents (4-connectivity)."""

import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.ops.ccl import (
    component_areas,
    label_components,
)


def _canonical_partition(labels: np.ndarray) -> dict:
    """Map each foreground pixel set to a frozenset partition for comparison."""
    part = {}
    for val in np.unique(labels):
        ys, xs = np.where(labels == val)
        part.setdefault(val, frozenset(zip(ys.tolist(), xs.tolist())))
    return set(part.values())


def _check_mask(mask: np.ndarray, iters: int = 8):
    cv2 = require_cv2()
    ours = np.asarray(label_components(mask, num_iters=iters))
    h, w = mask.shape
    assert (ours[~mask] == h * w).all()
    _, theirs = cv2.connectedComponents(mask.astype(np.uint8), connectivity=4)
    ours_fg = {  # partition induced by our labels on foreground
        frozenset(map(tuple, np.argwhere((ours == v) & mask)))
        for v in np.unique(ours[mask])
    }
    theirs_fg = {
        frozenset(map(tuple, np.argwhere((theirs == v) & mask)))
        for v in np.unique(theirs[mask])
    }
    assert ours_fg == theirs_fg
    # canonical label = min flat index of the component
    for v in np.unique(ours[mask]):
        ys, xs = np.where(ours == v)
        assert v == (ys * w + xs).min()


def test_simple_blobs():
    mask = np.zeros((16, 16), bool)
    mask[2:5, 2:5] = True
    mask[8:14, 9:15] = True
    mask[0, 15] = True
    _check_mask(mask)


def test_concentric_ring():
    yy, xx = np.mgrid[0:32, 0:32]
    r = np.hypot(yy - 16, xx - 16)
    ring = (r > 6) & (r < 10)
    disk = r < 4
    _check_mask(ring | disk)


def test_random_noise_masks():
    rng = np.random.default_rng(3)
    for p in (0.2, 0.5, 0.7):
        mask = rng.random((48, 48)) < p
        _check_mask(mask, iters=10)


def test_spiral_converges():
    # worst-case-ish long path: nested rectangles connected at alternating ends
    mask = np.zeros((40, 40), bool)
    mask[0, :] = True
    mask[:, 0] = True
    mask[-1, :] = True
    mask[2:, -1] = True
    _check_mask(mask, iters=10)


def test_warm_start_consistency():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (48, 48), np.uint8)
    prev_mask = img <= 100
    cur_mask = img <= 120
    prev = label_components(prev_mask, num_iters=10)
    warm = np.asarray(label_components(cur_mask, num_iters=8, init_labels=prev))
    cold = np.asarray(label_components(cur_mask, num_iters=10))
    np.testing.assert_array_equal(warm, cold)


def test_component_areas():
    mask = np.zeros((16, 16), bool)
    mask[2:5, 2:5] = True  # 9 px
    mask[8:10, 8:12] = True  # 8 px
    lab = label_components(mask)
    areas = np.asarray(component_areas(lab))
    assert areas[3, 3] == 9
    assert areas[8, 10] == 8
    assert areas[0, 0] == 0


def test_scan_ccl_matches_hook_ccl():
    from traffic_sign_detector.ops.ccl import label_components_scan

    rng = np.random.default_rng(21)
    # subcritical noise (small blobs): few alternations suffice; near the
    # percolation threshold components are serpentine and need ~turn-count
    # iterations — that's the documented contract of the scan variant
    for p, iters in ((0.3, 8), (0.55, 48)):
        mask = rng.random((64, 64)) < p
        ours = np.asarray(label_components_scan(mask, num_iters=iters))
        ref = np.asarray(label_components(mask, num_iters=12))
        np.testing.assert_array_equal(ours, ref)


def test_scan_ccl_ring_and_warm_start():
    from traffic_sign_detector.ops.ccl import label_components_scan

    yy, xx = np.mgrid[0:48, 0:48]
    r = np.hypot(yy - 24, xx - 24)
    mask = ((r > 8) & (r < 14)) | (r < 4)
    ours = np.asarray(label_components_scan(mask, num_iters=4))
    ref = np.asarray(label_components(mask, num_iters=12))
    np.testing.assert_array_equal(ours, ref)

    # warm start on sparse (sub-percolation) masks: prev-level labels carry
    # over and the result matches the converged hook-CCL reference
    img = np.random.default_rng(22).integers(0, 255, (48, 48), np.uint8)
    prev = label_components_scan(img <= 40, num_iters=8)
    warm = np.asarray(label_components_scan(img <= 60, num_iters=4, init_labels=prev))
    ref2 = np.asarray(label_components(img <= 60, num_iters=14))
    np.testing.assert_array_equal(warm, ref2)


# --- plain propagation vs the retired Pallas kernels' recorded outputs ---
# (tests/fixtures/kernel_fixtures.npz, scripts/gen_kernel_fixtures.py)


@pytest.fixture(scope="module")
def kernel_fixtures(fixtures_dir):
    return np.load(fixtures_dir / "kernel_fixtures.npz")


@pytest.mark.parametrize("density", [0.2, 0.5])
def test_roll_propagation_matches_kernel_fixture(kernel_fixtures, density):
    """Two 8-roll rounds of propagate_min_keys == the 16-iteration
    Pallas roll kernel it replaced, bit for bit."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.ccl import propagate_min_keys

    tag = f"rolls_{int(density * 10)}"
    keys = kernel_fixtures[f"{tag}_keys"]
    mask = kernel_fixtures[f"{tag}_mask"]
    out = propagate_min_keys(jnp.asarray(keys), jnp.asarray(mask), 2**21,
                             num_rolls=8, num_jumps=0, edges_safe=True)
    np.testing.assert_array_equal(np.asarray(out),
                                  kernel_fixtures[f"{tag}_out"])


@pytest.mark.parametrize("op", ["min", "max"])
def test_run_reduce_matches_numpy_runs(op):
    """run_reduce gives every pixel of a mask run the reduction over its
    whole run (both directions), and background the fill."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.ccl import run_reduce

    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1000, (3, 17, 29)).astype(np.int32)
    mask = rng.random(vals.shape) < 0.6
    fill = 10**6 if op == "min" else -1
    jop = jnp.minimum if op == "min" else jnp.maximum
    npop = np.min if op == "min" else np.max
    for axis in (-1, -2):
        got = np.asarray(run_reduce(jnp.asarray(vals), jnp.asarray(mask),
                                    fill, axis, jop))
        v = np.moveaxis(vals, axis, -1)
        m = np.moveaxis(mask, axis, -1)
        want = np.full(v.shape, fill, np.int64)
        for idx in np.ndindex(v.shape[:-1]):
            x = 0
            while x < v.shape[-1]:
                if not m[idx][x]:
                    x += 1
                    continue
                end = x
                while end < v.shape[-1] and m[idx][end]:
                    end += 1
                want[idx][x:end] = npop(v[idx][x:end])
                x = end
        np.testing.assert_array_equal(got, np.moveaxis(want, -1, axis))
