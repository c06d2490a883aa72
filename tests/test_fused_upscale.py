"""Folded upscale+patchify+stem (ops/fused_upscale.py) vs the two-stage
product path it replaces (upscale_bilinear_u8 -> stem_forward -> trunk)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from traffic_sign_detector.ops import fused_upscale as fu
from traffic_sign_detector.ops import upscale as up


def test_plan_finder_hits_the_shipped_operating_points():
    # --upscale 1.412 on GTSDB frames -> 24/17 (exactly 1360 -> 1920),
    # height padded 800 -> 816 -> 1152
    p = fu.find_plan(800, 1360, 1.412)
    assert (p.t, p.a) == (24, 17)
    assert (p.h_pad, p.w_pad) == (816, 1360)
    assert (p.h_out, p.w_out) == (1152, 1920)
    assert (p.sb, p.n) == (3, 17)
    # 1.6 -> 8/5, superblock of one stem row
    p = fu.find_plan(800, 1360, 1.6)
    assert (p.t, p.a) == (8, 5)
    assert (p.sb, p.n) == (1, 5)
    assert (p.h_out, p.w_out) == (1280, 2176)
    # integer 2x
    p = fu.find_plan(800, 1360, 2.0)
    assert (p.t, p.a) == (2, 1)
    # 1.51 snaps to 3/2 (err 0.01 within the 0.02 tolerance)
    p = fu.find_plan(800, 1360, 1.51)
    assert (p.t, p.a) == (3, 2)
    # no fusable rational within tolerance -> None (callers fall back)
    assert fu.find_plan(800, 1360, 1.55) is None
    assert fu.find_plan(800, 1360, 0.9) is None


def test_plan_alignment_invariants():
    for h, w, s in [(800, 1360, 1.412), (1088, 1920, 1.412),
                    (800, 1360, 1.6), (160, 160, 1.412)]:
        p = fu.find_plan(h, w, s)
        assert p is not None, (h, w, s)
        assert p.h_pad % p.n == 0
        assert p.h_out % 16 == 0 and p.w_out % 16 == 0
        assert p.h_out % (p.sb * 8) == 0 and p.w_out % 8 == 0
        assert p.h_out * p.a == p.h_pad * p.t
        assert p.w_out * p.a == p.w_pad * p.t
        assert p.sb == math.lcm(8, p.t) // 8


def test_superblock_taps_partition_of_unity():
    for t, a in [(24, 17), (8, 5), (2, 1), (16, 11)]:
        sb = math.lcm(8, t) // 8
        n = sb * 8 * a // t
        tap = fu._superblock_taps(t, a, sb, n)
        assert tap.shape == (sb, 8, n + 2)
        np.testing.assert_allclose(tap.sum(axis=-1), 1.0, atol=1e-6)


def _reference_stem_unrounded(frames_u8, kernel, bias, plan):
    """The same linear map, un-folded: phase-sliced upscale on both axes
    with NO u8 round of the intermediate, then normalize, patchify, stem
    matmul — all in f32.  Must match fused_upscale_stem to float rounding."""
    x = jnp.pad(frames_u8, ((0, 0), (0, plan.h_pad - plan.h),
                            (0, plan.w_pad - plan.w), (0, 0)), mode="edge")
    if plan.h_out != plan.h_pad:
        x = up._upscale_axis(x, 1, plan.h_out)
    if plan.w_out != plan.w_pad:
        x = up._upscale_axis(x, 2, plan.w_out)
    x = x.astype(jnp.float32) / 255.0 - 0.5
    b, th, tw, c = x.shape
    xs = x.reshape(b, th // 8, 8, tw // 8, 8 * c)
    patches = jnp.concatenate([xs[:, :, r] for r in range(8)], axis=-1)
    f = kernel.shape[-1]
    out = jnp.einsum("bhwk,kf->bhwf", patches, kernel.reshape(192, f))
    return jax.nn.relu(out + bias)


@pytest.mark.parametrize("hw,scale", [
    ((68, 68), 1.412),    # 24/17, no padding (68 = 2*34)
    ((60, 76), 1.412),    # 24/17 with height AND width padding
    ((40, 80), 1.6),      # 8/5, sb = 1
    ((48, 32), 2.0),      # integer 2x
])
def test_fused_stem_matches_unrounded_reference_exactly(hw, scale):
    rng = np.random.default_rng(42)
    frames = jnp.asarray(rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8))
    kernel = jnp.asarray(rng.normal(0, 0.1, (8, 8, 3, 16)).astype(np.float32))
    bias = jnp.asarray(rng.normal(0, 0.1, 16).astype(np.float32))
    plan = fu.find_plan(*hw, scale)
    assert plan is not None
    got = np.asarray(fu.fused_upscale_stem(frames, kernel, bias, plan,
                                           dtype=jnp.float32))
    want = np.asarray(_reference_stem_unrounded(frames, kernel, bias, plan))
    assert got.shape == want.shape == (2, plan.h_out // 8, plan.w_out // 8,
                                       16)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_constant_frame_passes_through():
    """Bilinear partition of unity: a constant frame must produce the same
    activation everywhere, equal to the plain stem's on that constant."""
    rng = np.random.default_rng(1)
    kernel = jnp.asarray(rng.normal(0, 0.1, (8, 8, 3, 8)).astype(np.float32))
    bias = jnp.zeros(8, jnp.float32)
    frames = jnp.full((1, 68, 68, 3), 199, jnp.uint8)
    plan = fu.find_plan(68, 68, 1.412)
    out = np.asarray(fu.fused_upscale_stem(frames, kernel, bias, plan,
                                           dtype=jnp.float32))
    want = max(0.0, float(
        (199.0 / 255.0 - 0.5) * np.asarray(kernel).reshape(192, 8).sum(0)[0]))
    np.testing.assert_allclose(out[..., 0], want, atol=1e-4)
    np.testing.assert_allclose(
        out, np.broadcast_to(out[0, 0, 0], out.shape), atol=1e-4)


CKPT = "artifacts/cnn_detector/params.npz"
CKPT_INT8 = "artifacts/cnn_detector/params_int8.npz"


@pytest.fixture(scope="module")
def real_detector():
    import os

    from traffic_sign_detector.models.cnn_detector import (
        CNNDetector,
    )

    if not os.path.exists(CKPT):
        pytest.skip("shipped checkpoint not present")
    return CNNDetector.load(CKPT)


def test_fused_detect_agrees_with_two_stage_product_path(real_detector):
    """Same scale ratio (24/17 on 68x68 needs no padding, and the old
    upscaled_hw rounds to the same 96x96 target): the fused jit and the
    materialize-then-forward jit must produce matching detections — the
    only semantic difference is the u8 round of the intermediate frame."""
    import copy

    det = copy.copy(real_detector)
    det.upscale = 1.412
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 68, 68, 3), np.uint8)
    plan = det._fused_plan(68, 68)
    assert plan is not None and (plan.t, plan.a) == (24, 17)
    assert (plan.h_pad, plan.w_pad) == (68, 68)

    from traffic_sign_detector.models import cnn_detector as cd

    fused = cd._detect_fused_upscaled_jit(
        det.cfg, det.params, jnp.asarray(frames), det.cfg.max_detections,
        det.cfg.score_threshold, plan)
    staged = cd._detect_upscaled_jit(
        det.cfg, det.params, jnp.asarray(frames), det.cfg.max_detections,
        det.cfg.score_threshold, 96, 96)
    # compare the score fields of the top peaks: the u8 round perturbs
    # activations by <0.2% of the input range, so ranked scores agree
    # closely even though exact box sets may differ at the margin
    s_f = np.sort(np.asarray(fused[2]), axis=-1)
    s_s = np.sort(np.asarray(staged[2]), axis=-1)
    np.testing.assert_allclose(s_f, s_s, atol=0.05)
    b_f = np.asarray(fused[0])
    assert np.isfinite(b_f).all()


def test_dispatch_routes_through_fused_plan(real_detector, monkeypatch):
    import copy

    from traffic_sign_detector.models import cnn_detector as cd

    det = copy.copy(real_detector)
    det.upscale = 1.412
    called = {}
    real = cd._detect_fused_upscaled_jit

    def spy(cfg, params, frames, k, thresh, plan):
        called["plan"] = plan
        return real(cfg, params, frames, k, thresh, plan)

    monkeypatch.setattr(cd, "_detect_fused_upscaled_jit", spy)
    frames = np.zeros((1, 160, 160, 3), np.uint8)
    out = det.dispatch(frames)
    assert np.asarray(out[0]).shape == (1, det.cfg.max_detections, 4)
    assert called["plan"].t == 24 and called["plan"].a == 17


def test_int8_fused_agrees_with_int8_two_stage():
    import copy
    import os

    from traffic_sign_detector.models import cnn_quant as cq

    if not os.path.exists(CKPT_INT8):
        pytest.skip("int8 artifact not present")
    det = cq.QuantCNNDetector.load(CKPT_INT8)
    det = copy.copy(det)
    det.upscale = 1.412
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (1, 68, 68, 3), np.uint8)
    plan = det._fused_plan(68, 68)
    assert plan is not None
    fused = cq._detect_int8_fused_upscaled_jit(
        det.cfg, det.q, jnp.asarray(frames), det.cfg.max_detections,
        det.cfg.score_threshold, plan)
    staged = cq._detect_int8_upscaled_jit(
        det.cfg, det.q, jnp.asarray(frames), det.cfg.max_detections,
        det.cfg.score_threshold, 96, 96)
    s_f = np.sort(np.asarray(fused[2]), axis=-1)
    s_s = np.sort(np.asarray(staged[2]), axis=-1)
    np.testing.assert_allclose(s_f, s_s, atol=0.06)


def test_v3_trunk_heads_matches_full_network(real_detector):
    """trunk_heads_forward over stem_forward activations == forward: the
    split the fused-upscale path uses must be bit-compatible with the
    whole network."""
    from traffic_sign_detector.models import cnn_detector as cd

    det = real_detector
    rng = np.random.default_rng(7)
    frames = jnp.asarray(rng.integers(0, 256, (1, 64, 64, 3),
                                      dtype=np.uint8))
    dt = det.cfg.compute_dtype()
    full = cd.forward(det.params, frames, dt)
    stem = cd.stem_forward(det.params["Conv_0"], frames, dt)
    split = cd.trunk_heads_forward(det.params, stem, dt)
    for key in full:
        np.testing.assert_array_equal(np.asarray(full[key]),
                                      np.asarray(split[key]))
