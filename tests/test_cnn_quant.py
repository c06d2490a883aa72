"""Int8 serving path: float-parity, layout agreement, artifact round-trip.

The quantized chain must (a) restate the float v3 forward exactly when
quantization error is removed, (b) track the real float model closely on
random weights + real-ish frames, and (c) plug into the CNNDetector
contract (dispatch/collect/run_directory) through its own npz artifact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from traffic_sign_detector.models import cnn_detector as cd
from traffic_sign_detector.models import cnn_quant as cq


@pytest.fixture(scope="module")
def v3_setup():
    cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8,
                               score_threshold=0.3)
    params = dict(cd.init_params(3))
    # make the detector fire somewhere so box-level checks are non-vacuous:
    # lift the heatmap bias and pin sizes positive
    params["Conv_4"] = {"kernel": params["Conv_4"]["kernel"],
                        "bias": params["Conv_4"]["bias"] + 4.0}
    params["Conv_5"] = {"kernel": params["Conv_5"]["kernel"],
                        "bias": params["Conv_5"]["bias"] + 1.0}
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (3, 64, 96, 3)).astype(np.uint8)
    return cfg, params, frames


def test_float_activations_match_flax(v3_setup):
    """The calibration-side float restatement == the float forward
    (same post-relu trunk activations feeding the heads)."""
    cfg, params, frames = v3_setup
    acts = cq.v3_float_activations(params, jnp.asarray(frames))
    # reconstruct head outputs from the last activation and compare with
    # the module's own outputs (f32 compute dtype isolates quant math)
    out_ref = cd.forward(params, jnp.asarray(frames), jnp.float32)
    from jax import lax

    h = acts[-1]
    for i, name in cq._HEADS.items():
        k = jnp.asarray(params[f"Conv_{i}"]["kernel"], jnp.float32)
        b = jnp.asarray(params[f"Conv_{i}"]["bias"], jnp.float32)
        dn = lax.conv_dimension_numbers(h.shape, k.shape,
                                        ("NHWC", "HWIO", "NHWC"))
        out = lax.conv_general_dilated(h, k, (1, 1), "SAME",
                                       dimension_numbers=dn) + b
        np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref[name]),
                                   rtol=1e-4, atol=1e-4)


def test_int8_tracks_float(v3_setup):
    """End-to-end int8 head maps stay close to the f32 model on data inside
    the calibration distribution (per-tensor scales, per-channel weights)."""
    cfg, params, frames = v3_setup
    q = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames, percentile=100.0).items()}
    out_q = cq.v3_int8_forward(q, jnp.asarray(frames))
    out_f = cd.forward(params, jnp.asarray(frames), jnp.float32)
    for name in ("hm", "size", "off"):
        a = np.asarray(out_q[name]).ravel()
        b = np.asarray(out_f[name]).ravel()
        corr = np.corrcoef(a, b)[0, 1]
        assert corr > 0.995, f"{name}: int8/f32 correlation {corr:.4f}"
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() / scale < 0.08, (
            f"{name}: max rel err {np.abs(a - b).max() / scale:.4f}")


def test_int8_decode_agrees_with_float(v3_setup):
    """Decoded detections from the int8 path land on the float path's
    cells with matching classes (scores may differ at quant precision)."""
    cfg, params, frames = v3_setup
    q = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames, percentile=100.0).items()}
    bq, cq_, sq, vq = cq._detect_int8_jit(cfg, q, jnp.asarray(frames),
                                          cfg.max_detections, 0.3)
    bf, cf, sf, vf = cd._detect_jit(
        cd.CNNDetectorConfig(arch="v3", dtype="float32", max_detections=8,
                             score_threshold=0.3),
        params, jnp.asarray(frames), cfg.max_detections, 0.3)
    vq, vf = np.asarray(vq), np.asarray(vf)
    assert vq.sum() > 0 and vf.sum() > 0
    # top-1 per frame must agree on class and center cell
    for i in range(frames.shape[0]):
        if not (vf[i, 0] and vq[i, 0]):
            continue
        assert int(np.asarray(cq_)[i, 0]) == int(np.asarray(cf)[i, 0])
        cq_box = np.asarray(bq)[i, 0]
        cf_box = np.asarray(bf)[i, 0]
        cq_ctr = [(cq_box[0] + cq_box[2]) / 2, (cq_box[1] + cq_box[3]) / 2]
        cf_ctr = [(cf_box[0] + cf_box[2]) / 2, (cf_box[1] + cf_box[3]) / 2]
        assert abs(cq_ctr[0] - cf_ctr[0]) <= 16
        assert abs(cq_ctr[1] - cf_ctr[1]) <= 16


def test_patches8_layout_agrees(v3_setup):
    """The int8 stem consumes [B,H,W,3] and the host patches8 layout
    [B,H/8,W/8,192] identically (same integers, zero relayout)."""
    cfg, params, frames = v3_setup
    q = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames, percentile=100.0).items()}
    patches = np.asarray(cd.patchify(jnp.asarray(frames)))
    out_a = cq.v3_int8_forward(q, jnp.asarray(frames))
    out_b = cq.v3_int8_forward(q, jnp.asarray(patches))
    for name in ("hm", "size", "off"):
        np.testing.assert_array_equal(np.asarray(out_a[name]),
                                      np.asarray(out_b[name]))


def test_artifact_roundtrip_and_loader_dispatch(v3_setup, tmp_path):
    cfg, params, frames = v3_setup
    q = cq.quantize_v3(params, frames)
    path = str(tmp_path / "params_int8.npz")
    cq.save_quant_params(path, q, arch="v3", score_threshold=0.3,
                         source_sha256="abc123")
    assert cq.saved_quant(path) == "int8"
    det = cq.load_detector(path)
    assert isinstance(det, cq.QuantCNNDetector)
    assert det.cfg.arch == "v3"
    assert det.cfg.score_threshold == pytest.approx(0.3)
    out = det.dispatch(frames)
    dets = det.collect(out, ["a.jpg", "b.jpg", "c.jpg"],
                       orig_hw=(64, 96))
    for d in dets:
        assert 0 <= d.x1 <= d.x2 <= 95 and 0 <= d.y1 <= d.y2 <= 63
        assert 1 <= d.class_id <= 6

    # float checkpoints still load as the float class through load_detector
    fpath = str(tmp_path / "params.npz")
    cd.save_params(fpath, params, arch="v3", score_threshold=0.3)
    assert cq.saved_quant(fpath) is None
    fdet = cq.load_detector(fpath)
    assert isinstance(fdet, cd.CNNDetector)
    assert not isinstance(fdet, cq.QuantCNNDetector)


def test_float_heads_variant(v3_setup, tmp_path):
    """float_heads=True keeps head weights in float: closer head maps than
    the all-int8 variant, same artifact/loader plumbing."""
    cfg, params, frames = v3_setup
    qf = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames, percentile=100.0, float_heads=True).items()}
    qi = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames, percentile=100.0).items()}
    out_f = cd.forward(params, jnp.asarray(frames), jnp.float32)
    err = {}
    for q, tag in ((qf, "fh"), (qi, "int")):
        out_q = cq.v3_int8_forward(q, jnp.asarray(frames))
        err[tag] = max(
            float(np.abs(np.asarray(out_q[n]) - np.asarray(out_f[n])).max())
            for n in ("hm", "size", "off"))
    assert err["fh"] <= err["int"] * 1.5  # never meaningfully worse
    # artifact roundtrip with float heads
    path = str(tmp_path / "p_fh.npz")
    cq.save_quant_params(path, cq.quantize_v3(params, frames,
                                              float_heads=True),
                         arch="v3", score_threshold=0.3)
    det = cq.load_detector(path)
    assert isinstance(det, cq.QuantCNNDetector)
    out = det.dispatch(frames)
    assert np.asarray(out[0]).shape[0] == frames.shape[0]


def test_stem_affine_fold_is_exact():
    """With quantization error removed (weights already exact multiples of
    the scale, requant disabled), the stem epilogue's folded affine equals
    the float stem bit-for-math: relu((x/255-0.5)@W + b)."""
    rng = np.random.default_rng(11)
    f = 8
    # weights on an exact int grid with per-channel max pinned at 127 so
    # _channel_scales lands exactly on the grid step and _quant_weight is
    # lossless
    w_int = rng.integers(-126, 127, (cq.STEM_K, f)).astype(np.float32)
    w_int[0, :] = 127.0
    scale = 0.01
    params = {"Conv_0": {"kernel": (w_int * scale).reshape(8, 8, 3, f),
                         "bias": rng.standard_normal(f).astype(np.float32)}}
    x = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)

    k0 = params["Conv_0"]["kernel"].reshape(cq.STEM_K, f)
    sw = cq._channel_scales(k0)
    qk = cq._quant_weight(k0, sw)
    np.testing.assert_allclose(qk * sw, k0, rtol=1e-6)

    xs = (x.astype(np.int64) - 128)
    patches = np.asarray(cd.patchify(jnp.asarray(x))).astype(np.int64) - 128
    acc = patches.reshape(-1, cq.STEM_K) @ qk.astype(np.int64)
    got = np.maximum(
        acc.astype(np.float64) * (sw / 255.0)
        + params["Conv_0"]["bias"]
        + (128.0 / 255.0 - 0.5) * k0.sum(axis=0), 0.0)

    xf = np.asarray(cd.patchify(jnp.asarray(x))).astype(np.float64) / 255.0 \
        - 0.5
    want = np.maximum(xf.reshape(-1, cq.STEM_K) @ k0.astype(np.float64)
                      + params["Conv_0"]["bias"], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_int8_upscaled_dispatch_equals_manual(v3_setup, monkeypatch):
    """QuantCNNDetector(upscale=s) on the TWO-STAGE path == upscale on
    device -> int8 detect -> boxes / s (same contract as the float
    detector's --upscale).  Plan finder disabled so the fallback path
    stays contracted; fused-path agreement is in test_fused_upscale.py."""
    from traffic_sign_detector.ops import fused_upscale as fu

    monkeypatch.setattr(fu, "find_plan", lambda *a, **k: None)
    cfg, params, frames = v3_setup
    q = {k: jnp.asarray(v) for k, v in cq.quantize_v3(
        params, frames).items()}
    det = cq.QuantCNNDetector(q, cfg, upscale=2.0)
    b_up, c_up, s_up, v_up = [np.asarray(o) for o in det.dispatch(frames)]

    big = cd.upscale_frames(jnp.asarray(frames), 128, 192)
    base = cq.QuantCNNDetector(q, cfg)
    b_ref, c_ref, s_ref, v_ref = [np.asarray(o)
                                  for o in base.dispatch(np.asarray(big))]
    b_ref = b_ref / 2.0

    assert np.array_equal(c_up, c_ref)
    assert np.array_equal(v_up, v_ref)
    np.testing.assert_allclose(s_up, s_ref, atol=1e-5)
    np.testing.assert_allclose(b_up, b_ref, atol=1e-3)


@pytest.mark.parametrize("hw,cin,cout,stride", [
    ((100, 170), 64, 128, 2),   # Conv_1 at the GTSDB s8 grid
    ((50, 85), 128, 16, 1),     # fused heads at the s16 grid
    ((51, 86), 8, 10, 2),       # odd sizes: asymmetric SAME padding
    ((7, 9), 4, 3, 1),
])
def test_conv_s8_matches_int_conv(hw, cin, cout, stride):
    """The int8 GEMM formulation == XLA's s8 conv with int32 accumulation,
    bit for bit (the conv is the reference; CUDA cannot lower it)."""
    from jax import lax

    rng = np.random.default_rng(sum(hw) + cin)
    h = rng.integers(-128, 128, (2, *hw, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    got = np.asarray(cq.conv_s8(jnp.asarray(h), jnp.asarray(k), stride))
    want = np.asarray(lax.conv_general_dilated(
        h, k, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
