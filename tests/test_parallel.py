"""Multi-chip sharding on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from traffic_sign_detector.config import MSERConfig
from traffic_sign_detector.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    data_mesh,
    shard_batch,
)
from traffic_sign_detector.parallel.train import (
    distributed_lda_fit,
    distributed_train_step,
    lda_from_statistics,
    _class_statistics,
)


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8
    mesh = data_mesh()
    assert mesh.shape[DATA_AXIS] == 8


def test_shard_batch_places_across_devices():
    mesh = data_mesh()
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    sx = shard_batch(mesh, x)
    assert sx.sharding == batch_sharding(mesh)
    assert len(set(d for d in sx.sharding.device_set)) == 8
    np.testing.assert_array_equal(np.asarray(sx), x)


def test_distributed_lda_fit_matches_single_device():
    mesh = data_mesh()
    rng = np.random.default_rng(13)
    n, d = 8 * 50, 16
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = rng.integers(0, 7, n).astype(np.int32)
    for c in range(7):  # make classes linearly separated
        X[y == c, c % d] += 4.0
    w = np.ones(n, np.float32)

    fit = distributed_lda_fit(mesh)
    coef, intercept = fit(
        shard_batch(mesh, X), shard_batch(mesh, y), shard_batch(mesh, w)
    )

    counts, sums, sq = _class_statistics(jnp.asarray(X), jnp.asarray(y),
                                         jnp.asarray(w))
    coef_ref, int_ref = lda_from_statistics(counts, sums, sq)
    np.testing.assert_allclose(np.asarray(coef), np.asarray(coef_ref),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(intercept), np.asarray(int_ref),
                               rtol=2e-3, atol=2e-2)

    # and the fit actually classifies the synthetic classes
    scores = X @ np.asarray(coef).T + np.asarray(intercept)
    assert (scores.argmax(1) == y).mean() > 0.9


@pytest.mark.slow
def test_sharded_detect_batch_matches_single_device():
    """Multi-chip *inference*: detect_batch sharded over the mesh equals the
    single-device run bit-for-bit (no cross-frame dependence)."""
    from traffic_sign_detector.config import PipelineConfig
    from traffic_sign_detector.models.detector import detect_batch
    from traffic_sign_detector.parallel.mesh import sharded_detect_fn

    rng = np.random.default_rng(21)
    b, h, w = 8, 128, 160
    frames = rng.integers(80, 170, (b, h, w, 3), np.uint8)
    for i in range(b):  # plant a dark square "sign" per frame
        x, y = 30 + (i % 4) * 12, 40
        frames[i, y : y + 20, x : x + 20] = 20
    red = (rng.random((6, 625)) < 0.3).astype(np.float32)
    blue = (rng.random((6, 625)) < 0.3).astype(np.float32)
    cfg = PipelineConfig(
        mser=MSERConfig(min_area=60, max_area=1200, max_variation=1.0,
                        max_regions=32),
        max_detections=16,
        batch_size=b,
    )

    single = detect_batch(jnp.asarray(frames), jnp.asarray(red),
                          jnp.asarray(blue), cfg)

    mesh = data_mesh()
    fn = sharded_detect_fn(mesh, cfg,
                           lambda f, r, b_: detect_batch(f, r, b_, cfg))
    sharded = fn(shard_batch(mesh, frames), jnp.asarray(red),
                 jnp.asarray(blue))
    assert sharded[0].sharding.spec == batch_sharding(mesh).spec
    for s, ref in zip(sharded, single):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(ref))


def test_sharded_recognize_batch_matches_single_device():
    """Multi-chip recognition inference: recognize_batch sharded over the
    mesh equals the single-device run bit-for-bit (LDABAYES heads
    replicated, frames batch-sharded, zero collectives)."""
    from traffic_sign_detector.config import (
        ClassifierConfig,
        PipelineConfig,
    )
    from traffic_sign_detector.models.lda import lda_fit
    from traffic_sign_detector.models.rec_pipeline import (
        recognize_batch,
    )
    from traffic_sign_detector.parallel.mesh import (
        sharded_recognize_fn,
    )

    rng = np.random.default_rng(23)
    b, h, w = 8, 128, 160
    frames = rng.integers(80, 170, (b, h, w, 3), np.uint8)
    for i in range(b):
        x, y = 30 + (i % 4) * 12, 40
        frames[i, y : y + 20, x : x + 20] = 20
    # six synthetic binary LDA heads on separable HOG-sized features
    coefs, ints = [], []
    for hseed in range(6):
        r = np.random.default_rng(hseed)
        X = np.concatenate([r.normal(0, 1, (40, 324)),
                            r.normal(2, 1, (40, 324))]).astype(np.float32)
        y = np.array([0] * 40 + [1] * 40)
        p = lda_fit(X, y)
        coefs.append(p.coef)
        ints.append(p.intercept)
    arrays = (jnp.asarray(np.stack(coefs), jnp.float32),
              jnp.asarray(np.stack(ints), jnp.float32))

    cfg = PipelineConfig(
        mser=MSERConfig(min_area=60, max_area=1200, max_variation=1.0,
                        max_regions=32),
        max_detections=16,
        batch_size=b,
    )
    single = recognize_batch(jnp.asarray(frames), arrays, cfg, "HOG",
                             "LDABAYES")

    mesh = data_mesh()
    fn = sharded_recognize_fn(mesh, cfg, "HOG", "LDABAYES")
    sharded = fn(shard_batch(mesh, frames), arrays)
    assert sharded[0].sharding.spec == batch_sharding(mesh).spec
    for s, ref in zip(sharded, single):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(ref))


@pytest.mark.slow
def test_detection_pipeline_accepts_mesh():
    """DetectionPipeline(mesh=...) routes batches through the sharded fn."""
    from traffic_sign_detector.config import PipelineConfig
    from traffic_sign_detector.models.detector import (
        DetectionPipeline,
    )
    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
    )

    rng = np.random.default_rng(22)
    templates = MeanMaskTemplates(
        red=(rng.random((6, 625)) < 0.3).astype(np.float32),
        blue=(rng.random((6, 625)) < 0.3).astype(np.float32),
    )
    cfg = PipelineConfig(
        mser=MSERConfig(min_area=60, max_area=1200, max_variation=1.0,
                        max_regions=32),
        max_detections=16,
        batch_size=8,
    )
    frames = rng.integers(80, 170, (8, 128, 160, 3), np.uint8)
    frames[:, 40:60, 30:50] = 20
    names = [f"{i:05d}.jpg" for i in range(8)]

    pipe = DetectionPipeline(cfg=cfg, templates=templates, mesh=data_mesh())
    assert pipe._sharded_fn is not None
    dets_sharded = pipe.detect_frames(frames, names)
    dets_single = DetectionPipeline(cfg=cfg, templates=templates).detect_frames(
        frames, names
    )
    assert [(d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id)
            for d in dets_sharded] == [
        (d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id) for d in dets_single
    ]

    with pytest.raises(ValueError, match="divisible"):
        DetectionPipeline(
            cfg=PipelineConfig(mser=cfg.mser, batch_size=3),
            templates=templates, mesh=data_mesh(),
        )


@pytest.mark.slow
def test_distributed_head_fit_parity_with_lda_fit_on_real_hog():
    """The SPMD sufficient-statistics head fit must agree
    with the sklearn-parity svd path (`models/lda.py:62` lda_fit) on real
    HOG descriptors — >= 99 % predicted-label agreement per head."""
    import os

    from traffic_sign_detector.data.gt import load_ground_truth
    from traffic_sign_detector.data.images import load_image_bgr
    from traffic_sign_detector.models.lda import (
        lda_fit,
        lda_predict_proba,
    )
    from traffic_sign_detector.models.recognizer import (
        SignClassifier,
    )
    from traffic_sign_detector.config import ClassifierConfig
    from traffic_sign_detector.ops.color import bgr_to_gray
    from traffic_sign_detector.ops.hog import hog_descriptors
    from traffic_sign_detector.ops.resize import crop_and_resize
    from traffic_sign_detector.parallel.train import (
        fit_classifier_distributed,
    )

    train_dir = "/root/reference/Deteción de Objetos/train_jpg"
    gt_path = os.path.join(train_dir, "gt.txt")
    if not os.path.isfile(gt_path):
        pytest.skip("reference GTSDB train set not available")

    # positives: GT crops from the first frames; negatives: shifted crops
    records = [r for r in load_ground_truth(gt_path, drop_unmapped=True)]
    by_file: dict = {}
    for r in records:
        by_file.setdefault(r.filename, []).append(r)
    rng = np.random.default_rng(3)
    pos_crops, pos_types, neg_crops = [], [], []
    for fname in sorted(by_file)[:30]:
        img = load_image_bgr(os.path.join(train_dir, fname))
        gray = np.asarray(bgr_to_gray(jnp.asarray(img)))
        h, w = gray.shape
        for r in by_file[fname]:
            boxes = jnp.asarray([[r.x1, r.y1, r.x2, r.y2]], jnp.int32)
            pos_crops.append(
                np.asarray(crop_and_resize(jnp.asarray(gray), boxes, 32)[0])
            )
            pos_types.append(r.class_id)
        for _ in range(4):  # background windows away from anything square
            x = int(rng.integers(0, w - 60))
            y = int(rng.integers(0, h - 60))
            s = int(rng.integers(24, 60))
            boxes = jnp.asarray([[x, y, x + s, y + s]], jnp.int32)
            neg_crops.append(
                np.asarray(crop_and_resize(jnp.asarray(gray), boxes, 32)[0])
            )

    pos_feats = np.asarray(hog_descriptors(jnp.asarray(np.stack(pos_crops))))
    neg_feats = np.asarray(hog_descriptors(jnp.asarray(np.stack(neg_crops))))
    pos_types = np.asarray(pos_types)
    feats = {0: neg_feats}
    for t in range(1, 7):
        feats[t] = pos_feats[pos_types == t]

    mesh = data_mesh()
    cfg = ClassifierConfig.from_string("HOG_LDA_BAYES")
    dist_clf = fit_classifier_distributed(feats, cfg, mesh)
    assert isinstance(dist_clf, SignClassifier)

    Xall = np.concatenate([neg_feats, pos_feats])
    checked = 0
    for t in range(1, 7):
        pos = feats[t]
        if len(pos) < 4 or dist_clf.heads[t - 1] is None:
            continue
        X = np.concatenate([neg_feats, pos])
        y = np.concatenate([np.zeros(len(neg_feats)), np.full(len(pos), t)])
        ref_head = lda_fit(X, y)
        p_ref = np.asarray(lda_predict_proba(ref_head, Xall))
        p_dist = np.asarray(lda_predict_proba(dist_clf.heads[t - 1], Xall))
        agree = ((p_ref[:, 1] > 0.5) == (p_dist[:, 1] > 0.5)).mean()
        assert agree >= 0.99, f"head {t}: agreement {agree:.3f}"
        checked += 1
    assert checked >= 3  # the sampled frames must cover several types


@pytest.mark.slow
def test_distributed_train_step_compiles_and_runs():
    """Full SPMD train step (MSER -> HOG -> psum LDA) on tiny frames."""
    mesh = data_mesh()
    cfg = MSERConfig(min_area=60, max_area=1200, max_variation=1.0,
                     max_regions=32)
    step = distributed_train_step(mesh, cfg)

    rng = np.random.default_rng(14)
    b, h, w, g = 8, 96, 96, 2
    frames = rng.integers(90, 140, (b, h, w, 3), np.uint8)
    gt_boxes = np.zeros((b, g, 4), np.int32)
    gt_types = np.zeros((b, g), np.int32)
    for i in range(b):
        x, y = 20 + (i % 3) * 10, 30
        frames[i, y : y + 24, x : x + 24] = 25
        gt_boxes[i, 0] = (x, y, x + 24, y + 24)
        gt_types[i, 0] = 1 + (i % 6)

    coef, intercept, counts = step(
        shard_batch(mesh, frames),
        shard_batch(mesh, gt_boxes),
        shard_batch(mesh, gt_types),
    )
    coef = np.asarray(coef)
    assert coef.shape == (7, 324)
    assert np.isfinite(coef).all()
    assert np.isfinite(np.asarray(intercept)).all()
    assert np.asarray(counts).sum() > 0


# ---------------------------------------------------------------------------
# Multi-host input feeding (SURVEY.md §2.5 DCN row)


def test_host_shard_files_disjoint_and_balanced():
    """Every simulated host count: disjoint cover + equal batch counts."""
    from traffic_sign_detector.parallel.multihost import (
        host_shard_files,
    )

    files = [f"{i:05d}.jpg" for i in range(150)]
    for pc in (1, 2, 3, 4, 7):
        shards = [
            host_shard_files(files, 8, process_index=p, process_count=pc)
            for p in range(pc)
        ]
        lens = {len(s) for s in shards}
        assert len(lens) == 1  # identical batch counts on every host
        assert next(iter(lens)) % 8 == 0
        seen = [f for s in shards for f in s]
        # non-pad entries cover the dataset exactly once
        per = -(-len(files) // pc)
        core = [
            f
            for p, s in enumerate(shards)
            for f in s[: max(0, min(per, len(files) - p * per))]
        ]
        assert core == files
        # pads only repeat a file already in that host's shard (or file 0)
        for s in shards:
            assert set(s) <= set(files)


def test_global_batch_from_local_single_process():
    """process_count=1: local batch becomes the batch-sharded global array."""
    from traffic_sign_detector.parallel.multihost import (
        global_batch_from_local,
        initialize_distributed,
    )

    assert initialize_distributed() is False  # no coordinator -> no-op
    mesh = data_mesh()
    local = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    g = global_batch_from_local(mesh, local)
    assert g.sharding == batch_sharding(mesh)
    assert g.shape == (8 * jax.process_count(), 3, 2)
    np.testing.assert_array_equal(np.asarray(g), local)


def test_multihost_batched_frames_feeds_mesh(tmp_path):
    """Host-sharded decode feeds a batch-sharded global array per step."""
    cv2 = pytest.importorskip("cv2")
    from traffic_sign_detector.parallel.multihost import (
        host_shard_files,
        multihost_batched_frames,
    )

    rng = np.random.default_rng(5)
    files = []
    for i in range(10):
        img = rng.integers(0, 255, (16, 24, 3), np.uint8)
        name = f"f{i:02d}.jpg"
        cv2.imwrite(str(tmp_path / name), img)
        files.append(name)

    mesh = data_mesh()
    got_names: list[str] = []
    steps = 0
    for frames, names in multihost_batched_frames(
        str(tmp_path), files, local_batch_size=8, mesh=mesh
    ):
        assert frames.sharding == batch_sharding(mesh)
        assert frames.shape == (8, 16, 24, 3)
        got_names += [n for n in names if n != "__pad__"]
        steps += 1
    assert got_names == files
    assert steps == len(host_shard_files(files, 8)) // 8
