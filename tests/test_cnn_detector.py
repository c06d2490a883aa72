"""CNN detector: plain forward vs the recorded flax model, target
rendering, decode, train-step convergence.

Pure-function tests (targets, decode) run in the fast lane; anything that
compiles the conv net is marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from traffic_sign_detector.models import cnn_detector as cd
from traffic_sign_detector.models import cnn_train as ct

CFG = cd.CNNDetectorConfig(max_detections=8, score_threshold=0.3)


def test_make_targets_center_properties():
    boxes = jnp.array([[40.0, 40.0, 80.0, 80.0], [0.0, 0.0, 0.0, 0.0]])
    cls = jnp.array([3, 0], jnp.int32)
    hm, wh, off, pos, mask = ct.make_targets(boxes, cls, 20, 20, stride=8)
    # center (60,60) px -> cell (7,7); gaussian peak exactly 1 on class 3
    assert float(hm[7, 7, 2]) == pytest.approx(1.0)
    assert float(hm.max()) == pytest.approx(1.0)
    assert int(jnp.argmax(hm.max(axis=(0, 1)))) == 2
    assert float(pos.sum()) == 1.0
    # 40 px box -> 5 grid units; fractional center offset 60/8 - 7 = 0.5
    assert np.allclose(np.asarray(wh[7, 7]), [5.0, 5.0])
    assert np.allclose(np.asarray(off[7, 7]), [0.5, 0.5])
    # other classes stay empty, loss mask fully on
    assert float(hm[:, :, 0].max()) == 0.0
    assert float(mask.min()) == 1.0


def test_make_targets_ignore_region_masks_loss():
    boxes = jnp.array([[40.0, 40.0, 80.0, 80.0]])
    cls = jnp.array([-1], jnp.int32)  # unmapped gt: ignore, not background
    hm, _, _, pos, mask = ct.make_targets(boxes, cls, 20, 20, stride=8)
    assert float(hm.max()) == 0.0
    assert float(pos.sum()) == 0.0
    assert float(mask[7, 7, 0]) == 0.0      # loss muted under the box
    assert float(mask[0, 0, 0]) == 1.0      # and live elsewhere


def test_decode_recovers_planted_peak():
    hc, wc = 16, 16
    hm = np.full((1, hc, wc, cd.NUM_CLASSES), -10.0, np.float32)
    hm[0, 5, 9, 3] = 10.0                    # class 4 peak at cell (5,9)
    size = np.zeros((1, hc, wc, 2), np.float32)
    size[0, 5, 9] = (4.0, 6.0)               # 32 x 48 px box
    off = np.zeros((1, hc, wc, 2), np.float32)
    off[0, 5, 9] = (0.25, 0.75)
    boxes, cls, scores, valid = cd.decode_detections(
        {"hm": jnp.asarray(hm), "size": jnp.asarray(size),
         "off": jnp.asarray(off)}, k=4, score_threshold=0.5, stride=8)
    assert bool(valid[0, 0]) and int(valid[0].sum()) == 1
    assert int(cls[0, 0]) == 4
    cx = (9 + 0.25) * 8
    cy = (5 + 0.75) * 8
    assert np.allclose(np.asarray(boxes[0, 0]),
                       [cx - 16, cy - 24, cx + 16, cy + 24], atol=1e-4)
    assert float(scores[0, 0]) > 0.99


def test_decode_nms_suppresses_non_peaks():
    hc, wc = 16, 16
    hm = np.full((1, hc, wc, cd.NUM_CLASSES), -10.0, np.float32)
    hm[0, 5, 9, 0] = 3.0
    hm[0, 5, 10, 0] = 2.0                    # adjacent, lower: pooled away
    size = np.full((1, hc, wc, 2), 3.0, np.float32)
    off = np.zeros((1, hc, wc, 2), np.float32)
    _, _, _, valid = cd.decode_detections(
        {"hm": jnp.asarray(hm), "size": jnp.asarray(size),
         "off": jnp.asarray(off)}, k=8, score_threshold=0.5)
    assert int(valid[0].sum()) == 1


@pytest.mark.slow
def test_model_forward_shapes_and_decode():
    params = cd.init_params(0)
    frames = np.zeros((2, 96, 96, 3), np.uint8)
    out = cd.forward(params, jnp.asarray(frames))
    assert out["hm"].shape == (2, 6, 6, cd.NUM_CLASSES)
    assert out["size"].shape == (2, 6, 6, 2)
    boxes, cls, scores, valid = cd.decode_detections(out, 8, 0.3)
    assert boxes.shape == (2, 8, 4)
    assert not bool(valid.any())  # untrained prior ~0.01 < threshold


@pytest.mark.slow
def test_save_load_roundtrip(tmp_path):
    params = cd.init_params(0)
    path = str(tmp_path / "params.npz")
    cd.save_params(path, params)
    loaded = cd.load_params(path, params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(loaded)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    det = cd.CNNDetector.load(path, CFG)
    assert det.cfg is CFG


@pytest.mark.slow
def test_v3_fold_matches_bn_eval_and_arch_roundtrip(tmp_path):
    """fold_v3_batchnorm must reproduce the BN-eval forward exactly (up to
    bf16 rounding), and the arch tag stored in the npz must let
    CNNDetector.load rebuild a v3 config with stride-16 decode."""
    cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8,
                               score_threshold=0.0)
    assert cfg.stride == 16
    m = ct.SignCenterNetV3Train(cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 256, (2, 64, 64, 3), np.uint8))
    v = m.init(jax.random.PRNGKey(0), x)
    params, stats = v["params"], v["batch_stats"]
    # perturb so the fold isn't trivially identity (fresh stats are 0/1)
    stats = jax.tree.map(
        lambda a: a + jnp.asarray(
            0.3 * rng.standard_normal(a.shape) ** 2, a.dtype), stats)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(
            0.05 * rng.standard_normal(a.shape), a.dtype), params)
    out_bn = m.apply({"params": params, "batch_stats": stats}, x,
                     train=False)
    folded = ct.fold_v3_batchnorm(params, stats)
    out_f = cd.forward(folded, x, cfg.compute_dtype())
    for k in out_bn:
        np.testing.assert_allclose(np.asarray(out_bn[k]),
                                   np.asarray(out_f[k]), atol=5e-2,
                                   rtol=2e-2)

    path = str(tmp_path / "v3.npz")
    cd.save_params(path, folded, arch="v3")
    assert cd.saved_arch(path) == "v3"
    det = cd.CNNDetector.load(path)  # no cfg: arch comes from the npz
    assert det.cfg.arch == "v3" and det.cfg.stride == 16
    out = det.dispatch(x)
    assert out[0].shape == (2, det.cfg.max_detections, 4)


@pytest.mark.slow
def test_v3_train_step_reduces_loss():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, ct.SLICE + 64, ct.SLICE + 64, 3),
                          dtype=np.uint8)
    boxes = np.zeros((3, ct.MAX_GT, 4), np.float32)
    cls = np.zeros((3, ct.MAX_GT), np.int32)
    for i in range(3):
        boxes[i, 0] = (200, 200, 260, 260)
        cls[i, 0] = (i % cd.NUM_CLASSES) + 1
    data = {"frames": jnp.asarray(frames), "boxes": jnp.asarray(boxes),
            "cls": jnp.asarray(cls),
            "pos": jnp.asarray([[i, 230.0, 230.0] for i in range(3)],
                               jnp.float32)}
    tcfg = ct.TrainConfig(batch_size=2, steps=30, warmup_steps=3, lr=1e-3,
                          pos_fraction=1.0)
    mcfg = cd.CNNDetectorConfig(arch="v3")
    step = jax.jit(ct.make_v3_train_step(mcfg, tcfg))
    v = ct.SignCenterNetV3Train(mcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, ct.CROP, ct.CROP, 3), jnp.uint8))
    params, stats = v["params"], v["batch_stats"]
    opt_state = ct.make_optimizer(tcfg).init(params)
    losses = []
    for s in range(tcfg.steps):
        params, stats, opt_state, m = step(params, stats, opt_state, data,
                                           jnp.int32(s))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---------------------------------------------------------------------------
# Upscaled-inference operating point (--upscale)
# ---------------------------------------------------------------------------


def test_upscaled_hw_rounds_to_stride():
    assert cd.upscaled_hw(800, 1360, 1.412, 16) == (1136, 1920)
    assert cd.upscaled_hw(800, 1360, 1.0, 16) == (800, 1360)
    assert cd.upscaled_hw(8, 8, 0.1, 16) == (16, 16)  # floor at one cell


@pytest.mark.slow
def test_upscaled_dispatch_equals_manual_upscale_plus_rescale(monkeypatch):
    """dispatch(upscale=s) on the TWO-STAGE path must equal: upscale frames
    on device -> detect -> divide boxes by s — the exact protocol the
    measured 1080p quality numbers were produced with
    (scripts/cnn_threshold_sweep.py).  The plan finder is disabled so the
    fallback path (non-fusable scales, non-v3 arches) stays contracted;
    the fused path's agreement is pinned in test_fused_upscale.py."""
    from traffic_sign_detector.ops import fused_upscale as fu

    monkeypatch.setattr(fu, "find_plan", lambda *a, **k: None)
    cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8,
                               score_threshold=0.0)
    params = cd.init_params(3)
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)

    det = cd.CNNDetector(params, cfg, upscale=2.0)
    assert det._fused_plan(64, 64) is None
    b_up, c_up, s_up, v_up = [np.asarray(o) for o in det.dispatch(frames)]

    big = cd.upscale_frames(jnp.asarray(frames), 128, 128)
    b_ref, c_ref, s_ref, v_ref = [
        np.asarray(o) for o in cd.CNNDetector(params, cfg).dispatch(
            np.asarray(big))]
    b_ref = b_ref / 2.0

    assert np.array_equal(c_up, c_ref)
    assert np.array_equal(v_up, v_ref)
    np.testing.assert_allclose(s_up, s_ref, atol=1e-5)
    np.testing.assert_allclose(b_up, b_ref, atol=1e-3)


@pytest.mark.slow
def test_upscaled_dispatch_rejects_patches8_layout():
    cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8)
    params = cd.init_params(0)
    det = cd.CNNDetector(params, cfg, upscale=1.5)
    with pytest.raises(ValueError, match="patches8"):
        det.dispatch(np.zeros((1, 8, 8, 192), np.uint8))


# ---------------------------------------------------------------------------
# Plain forward vs the flax module it replaced (recorded with the shipped
# weights by scripts/gen_kernel_fixtures.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shipped_params():
    import pathlib

    path = (pathlib.Path(__file__).parent.parent / "artifacts"
            / "cnn_detector" / "params.npz")
    return cd.load_params(str(path), cd.init_params(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax_head_maps(fixtures_dir, shipped_params, dtype):
    # op by op, as the flax module was recorded (a jit may fuse and
    # reassociate, which moves the last bit)
    fix = np.load(fixtures_dir / "cnn_v3_heads.npz")
    out = cd.forward(shipped_params, jnp.asarray(fix["frames"]),
                     jnp.dtype(dtype))
    for key in ("hm", "size", "off"):
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      fix[f"{dtype}_{key}"], err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_matches_flax_decode(fixtures_dir, shipped_params, dtype):
    """Decode (reduce_window max-pool NMS + top-k) reproduces the flax
    model's detections, boxes and scores included."""
    fix = np.load(fixtures_dir / "cnn_v3_heads.npz")
    cfg = cd.CNNDetectorConfig(dtype=dtype, score_threshold=0.0,
                               max_detections=16)
    det = cd.CNNDetector(shipped_params, cfg)
    out = det.dispatch(fix["frames"])
    for name, got in zip(("boxes", "cls", "scores", "valid"), out):
        np.testing.assert_array_equal(np.asarray(got),
                                      fix[f"{dtype}_det_{name}"],
                                      err_msg=name)


def test_inference_modules_import_without_flax():
    """flax and PIL are not dependencies of the inference path."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).parent.parent
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import traffic_sign_detector.models.cnn_detector\n"
        "import traffic_sign_detector.models.cnn_quant\n"
        "import traffic_sign_detector.models.detector\n"
        "import traffic_sign_detector.models.rec_pipeline\n"
        "import main_detection, main_recognition, serve_detection\n"
    )
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_config_rejects_other_archs():
    with pytest.raises(ValueError, match="arch"):
        cd.CNNDetectorConfig(arch="slim")
    assert cd.CNNDetectorConfig().stride == cd.STRIDE == 16
