"""MSER proposal quality: synthetic exact cases + OpenCV-oracle recall.

OpenCV MSER's exact region set is not bit-reproducible (tie-breaking,
min_diversity pruning), so the real-frame check asserts recall of OpenCV's
boxes rather than set equality; end-to-end detection parity is covered by the
pipeline tests.
"""

import os
import sys

import numpy as np
import pytest

from conftest import require_cv2

from traffic_sign_detector.config import MSERConfig
from traffic_sign_detector.ops.mser import mser_regions

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from gen_kernel_fixtures import (  # noqa: E402
    flood_cases,
    sweep_cases,
    sweep_setup,
)


def _iou_xywh(a, b):
    ax1, ay1, aw, ah = a
    bx1, by1, bw, bh = b
    ix = max(0, min(ax1 + aw, bx1 + bw) - max(ax1, bx1))
    iy = max(0, min(ay1 + ah, by1 + bh) - max(ay1, by1))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def test_dark_square_detected_exactly():
    img = np.full((128, 128), 200, np.uint8)
    img[20:50, 30:60] = 40  # 30x30 dark square, area 900
    cfg = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                     max_regions=64)
    boxes, valid = mser_regions(img, cfg)
    boxes = np.asarray(boxes)[np.asarray(valid)]
    assert len(boxes) >= 1
    best = max(_iou_xywh(b, (30, 20, 30, 30)) for b in boxes)
    assert best > 0.95


def test_bright_square_detected_via_inverted_polarity():
    img = np.full((128, 128), 30, np.uint8)
    img[60:90, 10:40] = 220
    cfg = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                     max_regions=64)
    boxes, valid = mser_regions(img, cfg)
    boxes = np.asarray(boxes)[np.asarray(valid)]
    assert len(boxes) >= 1
    best = max(_iou_xywh(b, (10, 60, 30, 30)) for b in boxes)
    assert best > 0.95


def test_sweep_res_refine_matches_native_box_geometry():
    """The sweep_res_pipeline knob refines at sweep resolution and scales
    boxes back: on a clean square the native-coord box must land within
    `downscale` px of the native-refined one."""
    img = np.full((128, 160), 200, np.uint8)
    img[40:76, 60:96] = 35  # 36x36 dark square
    base = dict(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                max_regions=64, downscale=2, ccl_iters=16, ccl_jumps=0)
    b_nat, v_nat = mser_regions(img, MSERConfig(**base))
    b_low, v_low = mser_regions(
        img, MSERConfig(**base, sweep_res_pipeline=True)
    )
    b_nat = np.asarray(b_nat)[np.asarray(v_nat)]
    b_low = np.asarray(b_low)[np.asarray(v_low)]
    assert len(b_nat) >= 1 and len(b_low) >= 1
    target = (60, 40, 36, 36)
    best_nat = max(b_nat, key=lambda b: _iou_xywh(b, target))
    best_low = max(b_low, key=lambda b: _iou_xywh(b, target))
    assert _iou_xywh(best_low, target) > 0.85
    assert np.abs(np.asarray(best_low) - np.asarray(best_nat)).max() <= 2


def test_area_window_respected():
    img = np.full((128, 128), 200, np.uint8)
    img[10:14, 10:14] = 40  # 16 px — below min_area
    img[40:120, 30:110] = 40  # 6400 px — above max_area
    cfg = MSERConfig(delta=5, min_area=200, max_area=2000, max_variation=1.0,
                     max_regions=64)
    boxes, valid = mser_regions(img, cfg)
    boxes = np.asarray(boxes)[np.asarray(valid)]
    for b in boxes:
        assert _iou_xywh(b, (10, 10, 4, 4)) < 0.5
        assert _iou_xywh(b, (30, 40, 80, 80)) < 0.5


@pytest.mark.slow
def test_recall_vs_opencv_on_real_crop(test_frames_dir):
    cv2 = require_cv2()
    img = cv2.imread(str(test_frames_dir / "00601.jpg"))
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    g = cv2.createCLAHE(clipLimit=2).apply(g)
    g = cv2.GaussianBlur(g, (3, 3), 0)
    lut = np.array([((i / 255) ** 0.5) * 255 for i in range(256)], np.uint8)
    g = cv2.LUT(g, lut)
    crop = g[384:640, 0:256]  # contains the prohibicion sign at (82, 450)

    cfg = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                     max_regions=512)
    boxes, valid = mser_regions(crop, cfg)
    ours = np.asarray(boxes)[np.asarray(valid)]

    mser = cv2.MSER_create(delta=7, min_area=200, max_area=2000,
                           max_variation=1.0)
    ref = mser.detectRegions(crop)[1]
    assert len(ref) > 0
    matched = sum(
        1 for rb in ref if any(_iou_xywh(rb, ob) >= 0.6 for ob in ours)
    )
    assert matched / len(ref) >= 0.75
    # don't over-generate unboundedly: nested duplicates are fine (downstream
    # dedup collapses them) but stay within a small multiple
    assert len(ours) <= 6 * len(ref) + 32

    # the sign itself (GT 00601: 82,450..145,508 -> crop coords 82,66..145,124)
    sign = (82, 66, 63, 58)
    assert any(_iou_xywh(sign, ob) >= 0.5 for ob in ours)




# ---------------------------------------------------------------------------
# bbox-area sweep + scan flood vs the retired Pallas kernels' recorded
# outputs (tests/fixtures/kernel_fixtures.npz; inputs and configs from
# scripts/gen_kernel_fixtures.py, which produced them through the Pallas
# interpreter).  The plain lax versions must match bit for bit.
# ---------------------------------------------------------------------------

SWEEP_CASES = sweep_cases()


@pytest.fixture(scope="module")
def kfix(fixtures_dir):
    return np.load(fixtures_dir / "kernel_fixtures.npz")


def _full(name):
    from traffic_sign_detector.ops.mser import (
        bbox_level_sweep_full,
    )

    g, cfg = SWEEP_CASES[name]
    im2, levels, d_idx = sweep_setup(g, cfg)
    return np.asarray(bbox_level_sweep_full(im2, cfg, d_idx, len(levels)))


def _packed(name):
    """Plain packed map on the pool-padded frame, as mser_regions runs it."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.mser import bbox_level_sweep

    g, cfg = SWEEP_CASES[name]
    im2, levels, d_idx = sweep_setup(g, cfg)
    pool = max(1, cfg.topk_pool)
    h, w = im2.shape[1:]
    hp, wp = -(-h // pool) * pool, -(-w // pool) * pool
    im2 = jnp.pad(im2, ((0, 0), (0, hp - h), (0, wp - w)),
                  constant_values=255)
    return np.asarray(bbox_level_sweep(im2, cfg, d_idx, len(levels)))


@pytest.mark.parametrize("name", ["rects_nodiv", "sqrect", "scene",
                                  "scene_ext"])
def test_full_map_matches_kernel_fixture(kfix, name):
    np.testing.assert_array_equal(_full(name), kfix[f"sweep_{name}_full"])


class TestFusedSweep:
    """bbox-area sweep (``fused_sweep``) vs the pixel-area sweep and its
    own properties."""

    def test_rectangles_agree_with_xla_sweep(self, kfix):
        # solid rectangles: bbox area == pixel area, so the two stability
        # definitions coincide and candidate maps should nearly match
        from traffic_sign_detector.ops import mser as M

        g, cfg = SWEEP_CASES["rects"]
        im2, levels, d_idx = sweep_setup(g, cfg)
        sb_x = np.asarray(M._level_sweep(im2, levels, cfg, d_idx))
        h, w = im2.shape[1:]
        sb_x4 = sb_x.reshape(len(levels), 2, h, w).transpose(1, 0, 2, 3)
        sb_f = _full("rects")
        np.testing.assert_array_equal(sb_f, kfix["sweep_rects_full"])
        assert (sb_x4 == sb_f).mean() > 0.999
        # both squares found at their anchor pixel
        assert sb_f[0, :, 41, 51].max() > 0
        assert sb_f[0, :, 81, 101].max() > 0

    def test_min_diversity_prunes_nested_reemissions(self, kfix):
        sb_div = _full("rects")
        sb_nodiv = _full("rects_nodiv")
        np.testing.assert_array_equal(sb_nodiv, kfix["sweep_rects_nodiv_full"])
        n_div = (sb_div[0, :, 41, 51] > 0).sum()
        n_nodiv = (sb_nodiv[0, :, 41, 51] > 0).sum()
        # a constant-size region must emit exactly once under diversity
        # pruning (it never grows), vs once per stable level without
        assert n_div == 1
        assert n_nodiv > 3

    def test_fused_pipeline_detects_square_on_cpu_interpret(self, kfix):
        """The whole proposal path at the detection CLI's operating point
        (downscale 2, 2 roll rounds, step 9, scan-flood refine) reproduces
        the retired kernels' boxes exactly."""
        import dataclasses

        import jax.numpy as jnp

        from traffic_sign_detector.ops.mser import mser_regions

        cfg = dataclasses.replace(MSERConfig(), downscale=2, ccl_iters=2,
                                  level_step=9, ccl_jumps=0,
                                  max_regions=128)
        boxes, valid = mser_regions(jnp.asarray(kfix["mser_cli_gray"]), cfg)
        assert int(np.asarray(valid).sum()) > 0
        np.testing.assert_array_equal(np.asarray(valid),
                                      kfix["mser_cli_valid"])
        np.testing.assert_array_equal(np.asarray(boxes),
                                      kfix["mser_cli_boxes"])


def test_extent_only_sweep_matches_on_squares(kfix):
    """Extent-only (3-channel) sweep: squared-height area proxy equals bbox
    area on square components, so candidate maps must match the full
    5-channel sweep there."""
    sb5 = _full("sqrect")
    sb3 = _full("sqrect_ext")
    np.testing.assert_array_equal(sb3, kfix["sweep_sqrect_ext_full"])
    assert sb3[0, :, 41, 51].max() > 0
    assert sb3[0, :, 81, 101].max() > 0
    np.testing.assert_array_equal(sb3[0, :, 41, 51], sb5[0, :, 41, 51])
    np.testing.assert_array_equal(sb3[0, :, 81, 101], sb5[0, :, 81, 101])


@pytest.mark.slow
def test_scan_propagation_matches_roll_candidates():
    """Scan-based propagation (segmented full-run resolves per axis) must
    find the same candidate set as the converged roll propagation; full
    convergence may legally emit a slow-to-flood shape a step earlier."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.mser import (
        bbox_level_sweep_full,
    )

    g = np.full((126, 158), 200, np.uint8)
    g[40:60, 50:70] = 30
    g[80:100, 100:140] = 90
    g[20:30, 10:15] = 60
    g[70:110, 20:30] = 45
    g[100:110, 20:60] = 45
    base = dict(min_area=20, max_area=3000, max_variation=1.0, level_step=5,
                ccl_iters=24, ccl_jumps=0, max_regions=64)
    s, d_idx = 5, 1
    levels = list(range(0, 256 + (d_idx + 1) * s + 1, s))
    gq = jnp.asarray(g)
    both = jnp.stack([gq.astype(jnp.int32), 255 - gq.astype(jnp.int32)])
    im2 = jnp.pad(both, ((0, 0), (1, 1), (1, 1)), constant_values=255)
    sb_roll = np.asarray(bbox_level_sweep_full(
        im2, MSERConfig(**base), d_idx, len(levels)))
    sb_scan = np.asarray(bbox_level_sweep_full(
        im2, MSERConfig(scan_passes=2, **base), d_idx, len(levels)))
    anchors_roll = {(p, y, x) for p, _, y, x in zip(*np.nonzero(sb_roll))}
    anchors_scan = {(p, y, x) for p, _, y, x in zip(*np.nonzero(sb_scan))}
    assert anchors_scan == anchors_roll
    # expected anchors: one per synthetic shape, dark polarity
    assert anchors_roll == {(0, 41, 51), (0, 81, 101), (0, 21, 11), (0, 71, 21)}


class TestPooledTiledSweep:
    """The level-collapsed packed map vs the full byte maps and the
    retired kernel's single- and multi-strip outputs."""

    @staticmethod
    def _expected_packed(sb_full, lbits, hp, wp):
        """Reference level collapse of the full [P, L, H, W] byte map."""
        p, nl, h, w = sb_full.shape
        x = np.zeros((p, nl, hp, wp), np.int64)
        x[:, :, :h, :w] = sb_full
        lv = np.arange(nl)[None, :, None, None]
        return (x * (1 << lbits) + lv).max(axis=1)

    def test_collapsed_output_matches_full_map(self):
        from traffic_sign_detector.ops.mser import packing_bits

        g, cfg = SWEEP_CASES["rects"]
        _, levels, _ = sweep_setup(g, cfg)
        packed = _packed("rects")
        _, lbits = packing_bits(cfg.topk_pool, len(levels))
        exp = self._expected_packed(_full("rects"), lbits, *packed.shape[1:])
        np.testing.assert_array_equal(packed, exp)

    def test_multi_strip_finds_candidates_in_every_strip(self, kfix):
        """Packed map == the kernel's single-strip output at two
        geometries (the kernel padded rows to 8, so compare the overlap);
        every planted shape's anchor emits."""
        from traffic_sign_detector.ops.mser import packing_bits

        anchors = {"strips": [(21, 31), (121, 21), (211, 41)],
                   "rects": [(41, 51), (81, 101)]}
        for name, points in anchors.items():
            packed = _packed(name)
            ref = kfix[f"sweep_{name}_packed"]
            h = min(packed.shape[1], ref.shape[1])
            np.testing.assert_array_equal(packed[:, :h], ref[:, :h])
            g, cfg = SWEEP_CASES[name]
            _, levels, _ = sweep_setup(g, cfg)
            _, lbits = packing_bits(cfg.topk_pool, len(levels))
            for ay, ax in points:
                assert (packed[0, ay, ax] >> lbits) > 0, (name, ay, ax)

    def test_multi_strip_matches_single_strip_candidates(self, kfix):
        """Sign-sized components fit the tiled kernel's halo, so its
        strip-tiled stability bytes equal the whole-frame sweep's."""
        from traffic_sign_detector.ops.mser import packing_bits

        g, cfg = SWEEP_CASES["strips"]
        _, levels, _ = sweep_setup(g, cfg)
        _, lbits = packing_bits(cfg.topk_pool, len(levels))
        sb = _packed("strips") >> lbits
        tiled = kfix["sweep_strips_tiled_packed"] >> lbits
        np.testing.assert_array_equal(tiled[:, :sb.shape[1]], sb)


# ---------------------------------------------------------------------------
# refinement flood
# ---------------------------------------------------------------------------

FLOOD_CASES = flood_cases()


def _seed_yx(seed_maps):
    """[N, H, W] seed maps (0 at the seed) -> [N, 2] (y, x) seeds."""
    import jax.numpy as jnp

    n, h, w = seed_maps.shape
    flat = np.argmin(seed_maps.reshape(n, -1), axis=1)
    return jnp.asarray(np.stack([flat // w, flat % w], -1), jnp.int32)


def _bfs_component(mask2d, seed_yx):
    from collections import deque

    h, w = mask2d.shape
    want = np.zeros((h, w), bool)
    sy, sx = seed_yx
    if not mask2d[sy, sx]:
        return want
    q = deque([(sy, sx)])
    want[sy, sx] = True
    while q:
        y, x = q.popleft()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if (0 <= yy < h and 0 <= xx < w and mask2d[yy, xx]
                    and not want[yy, xx]):
                want[yy, xx] = True
                q.append((yy, xx))
    return want


@pytest.mark.parametrize("name", sorted(FLOOD_CASES))
def test_flood_bbox_matches_kernel_fixture(kfix, name):
    """Plain scan flood + bbox reductions == the fused flood+bbox kernel."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.mser import flood_bbox

    seeds, masks, big, passes = FLOOD_CASES[name]
    out = np.stack(flood_bbox(jnp.asarray(masks), _seed_yx(seeds), big,
                              passes), axis=-1)
    np.testing.assert_array_equal(out, kfix[f"flood_{name}_out"])


def test_scan_flood_matches_bfs():
    """The segmented-scan flood reaches exactly the seed's component on
    sign-like shapes (blob + leg, ring) — checked against a BFS oracle
    through its bbox and area."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.mser import flood_bbox

    seeds, masks, big, passes = FLOOD_CASES["shapes64"]
    out = np.stack(flood_bbox(jnp.asarray(masks), _seed_yx(seeds), big,
                              passes), axis=-1)
    for p in range(seeds.shape[0]):
        sy, sx = np.argwhere(seeds[p] == 0)[0]
        comp = _bfs_component(masks[p], (sy, sx))
        ys, xs = np.nonzero(comp)
        if comp.any():
            exp = (ys.min(), ys.max(), xs.min(), xs.max(), comp.sum())
        else:
            exp = (big, -1, big, -1, 0)
        assert tuple(out[p]) == tuple(int(v) for v in exp), (p, out[p], exp)


@pytest.mark.gpu
def test_cuda_flood_matches_scan_flood():
    """The CUDA flood kernel == the plain scan flood, bit for bit (the
    same comparison chip_smoke.py's MSER phase makes at full size)."""
    import jax
    import jax.numpy as jnp

    from traffic_sign_detector.ops import flood_cuda
    from traffic_sign_detector.ops import mser as M

    if not flood_cuda.available():
        pytest.skip("needs a CUDA device: the flood kernel has no CPU or "
                    "interpret mode (chip_smoke.py checks it on the card)")
    for name, (seeds, masks, big, passes) in FLOOD_CASES.items():
        m, s = jnp.asarray(masks), _seed_yx(seeds)
        got = jax.jit(lambda m, s: flood_cuda.flood_bbox_cuda(
            m, s, big=big, passes=passes))(m, s)
        want = M._flood_bbox_scan(m, s, big=big, passes=passes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
