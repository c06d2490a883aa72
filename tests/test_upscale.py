"""Phase-sliced bilinear upscale (ops/upscale.py) vs the dense
jax.image.resize oracle it replaced in the --upscale product mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from traffic_sign_detector.ops import upscale as up


def _oracle(frames_u8, th, tw):
    b, _, _, c = frames_u8.shape
    out = jax.image.resize(frames_u8.astype(jnp.float32),
                           (b, th, tw, c), "bilinear")
    return np.asarray(jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8))


@pytest.mark.parametrize("hw,thw", [
    ((800, 1360), (1136, 1920)),   # the 1.412x product operating point
    ((64, 64), (128, 128)),        # integer 2x (T=2 per axis)
    ((50, 34), (71, 48)),          # odd gcds: T=71 rows / T=24 cols
    ((33, 16), (48, 48)),          # anisotropic: 1.45x rows, 3x cols
    ((16, 16), (16, 24)),          # identity rows, upscale cols only
])
def test_matches_dense_resize_within_one_count(hw, thw):
    rng = np.random.default_rng(11)
    shape = (2, *hw, 3) if hw[0] <= 128 else (1, *hw, 3)
    frames = jnp.asarray(rng.integers(0, 256, shape, dtype=np.uint8))
    got = np.asarray(up.upscale_bilinear_u8(frames, *thw))
    want = _oracle(frames, *thw)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # f64-baked scalar weights vs jax's normalized f32 weight matrix
    # differ by an ULP, which flips near-half rounds on a few % of pixels
    # — never by more than one u8 count
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.05


def test_edge_rows_replicate_like_dense_resize():
    """The 2-tap edge renormalization == replicate padding: for 20->30 the
    first/last output rows' out-of-range tap collapses all weight onto the
    edge pixel, so a rows-only upscale must reproduce the input's edge rows
    exactly; a constant frame must pass through any upscale unchanged."""
    rng = np.random.default_rng(3)
    frames = jnp.asarray(rng.integers(0, 256, (1, 20, 20, 3),
                                      dtype=np.uint8))
    got = np.asarray(up.upscale_bilinear_u8(frames, 30, 20))
    np.testing.assert_array_equal(got[:, 0], np.asarray(frames)[:, 0])
    np.testing.assert_array_equal(got[:, -1], np.asarray(frames)[:, -1])

    const = jnp.full((1, 20, 20, 3), 173, jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(up.upscale_bilinear_u8(const, 29, 31)), 173)


def test_degenerate_ratio_falls_back_to_dense():
    # gcd(127, 256) == 1 -> T == 256 > _MAX_PHASES: dense path, bit-exact
    rng = np.random.default_rng(5)
    frames = jnp.asarray(rng.integers(0, 256, (1, 127, 16, 3),
                                      dtype=np.uint8))
    assert up._phase_plan(127, 256) is None
    got = np.asarray(up.upscale_bilinear_u8(frames, 256, 16))
    np.testing.assert_array_equal(got, _oracle(frames, 256, 16))


def test_downscale_routes_to_dense_resize():
    """Sub-1.0 factors must work (dense path), not crash."""
    rng = np.random.default_rng(7)
    frames = jnp.asarray(rng.integers(0, 256, (1, 32, 48, 3),
                                      dtype=np.uint8))
    got = np.asarray(up.upscale_bilinear_u8(frames, 16, 24))
    np.testing.assert_array_equal(got, _oracle(frames, 16, 24))
    # mixed: downscale rows, upscale cols — each axis gated independently
    got = np.asarray(up.upscale_bilinear_u8(frames, 16, 96))
    want = _oracle(frames, 16, 96)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_per_axis_fallback_keeps_phase_path_on_good_axis():
    """One degenerate axis (T > _MAX_PHASES) must not force
    the other axis onto the dense path — result still matches the oracle."""
    rng = np.random.default_rng(9)
    # rows 127 -> 256 is degenerate (gcd 1); cols 16 -> 24 has T=3
    frames = jnp.asarray(rng.integers(0, 256, (1, 127, 16, 3),
                                      dtype=np.uint8))
    assert up._phase_plan(127, 256) is None
    assert up._phase_plan(16, 24) is not None
    got = np.asarray(up.upscale_bilinear_u8(frames, 256, 24))
    want = _oracle(frames, 256, 24)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_upscale_axis_raises_on_degenerate_plan():
    """A direct mis-call gets a ValueError, not an assert."""
    frames = jnp.zeros((1, 127, 16, 3), jnp.uint8)
    with pytest.raises(ValueError, match="no phase plan"):
        up._upscale_axis(frames, 1, 256)


def test_phase_plan_weights_sum_to_one():
    for in_size, out_size in [(800, 1136), (1360, 1920), (7, 12)]:
        plan = up._phase_plan(in_size, out_size)
        assert plan is not None
        A, g, T, taps = plan
        assert A * g == in_size and T * g == out_size
        for j, w0, w1 in taps:
            assert 0 <= j <= A + 1
            assert abs(w0 + w1 - 1.0) < 1e-12
            assert 0.0 <= w0 <= 1.0
