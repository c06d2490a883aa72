"""Fused recognition inference: head stacking + device/host consistency."""

import numpy as np
import pytest

from traffic_sign_detector.config import (
    ClassifierConfig,
    MSERConfig,
    PipelineConfig,
)
from traffic_sign_detector.models.rec_pipeline import (
    RecognitionPipeline,
    _stack_heads,
    classify_crops_lda,
)
from traffic_sign_detector.models.recognizer import (
    fit_classifier,
    predict_classifier,
)


def _features(seed=0, per=40, d=24):
    rng = np.random.default_rng(seed)
    feats = {}
    for c in range(7):
        center = np.zeros(d)
        if c > 0:
            center[c] = 5.0
        feats[c] = (center + rng.normal(0, 0.7, (per, d))).astype(np.float32)
    return feats


def test_fused_heads_match_per_head_prediction():
    feats = _features()
    clf = fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_LDABAYES"))
    X = np.concatenate([feats[c][:10] for c in range(7)])
    coefs, ints = _stack_heads(clf)
    labels, conf = classify_crops_lda(X, coefs, ints, tol=0.5)
    ref = predict_classifier(clf, X, no_sign_tol=0.5)
    np.testing.assert_array_equal(np.asarray(labels), ref)
    conf = np.asarray(conf)
    assert ((conf >= 0) & (conf <= 1)).all()


def test_knn_device_path_matches_host():
    import numpy as np
    from traffic_sign_detector.models.rec_pipeline import (
        classify_crops_knn,
    )

    feats = _features(seed=1)
    clf = fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_KNN"))
    X = np.concatenate([feats[c][:8] for c in range(7)])
    labels, conf = classify_crops_knn(
        X,
        clf.reducer.xbar.astype(np.float32),
        clf.reducer.scalings.astype(np.float32),
        clf.knn.train_x.astype(np.float32),
        clf.knn.train_y.astype(np.int32),
        clf.knn.classes.astype(np.int32),
        4,
    )
    ref = predict_classifier(clf, X)
    np.testing.assert_array_equal(np.asarray(labels), ref)
    conf = np.asarray(conf)
    assert ((conf >= 0.25) & (conf <= 1.0)).all()


@pytest.mark.slow
def test_recognize_frames_smoke(test_frames_dir, train_frames_dir):
    """Real-data smoke: train on a few crops, recognize in a frame region."""
    cv2 = pytest.importorskip("cv2")
    import os

    from traffic_sign_detector.ops.hog import hog_descriptors

    # quick LDABAYES trained on a handful of real crops per type + noise
    rng = np.random.default_rng(2)
    feats = {0: np.asarray(
        hog_descriptors(rng.integers(0, 256, (60, 32, 32), np.uint8))
    )}
    for t, d in ((1, "02"), (2, "11"), (3, "14"), (4, "17"), (5, "13"), (6, "38")):
        droot = os.path.join(str(train_frames_dir), d)
        crops = []
        for f in sorted(os.listdir(droot))[:12]:
            img = cv2.imread(os.path.join(droot, f))
            crops.append(cv2.cvtColor(cv2.resize(img, (32, 32)), cv2.COLOR_BGR2GRAY))
        feats[t] = np.asarray(hog_descriptors(np.stack(crops)))
    clf = fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_LDABAYES"))

    img = cv2.imread(str(test_frames_dir / "00601.jpg"))
    region = np.ascontiguousarray(img[384:640, 0:512])
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(
            mser=MSERConfig(max_variation=1.0, max_regions=256),
            max_detections=32,
            batch_size=1,
        ),
        classifier=clf,
    )
    dets = pipe.recognize_frames(region[None], ["region.jpg"])
    for d in dets:
        assert 1 <= d.class_id <= 6
        assert 0.0 <= d.score <= 1.0


def test_grow_boxes_xyxy_geometry():
    """Grow about center, clip to frame, keep half-open int semantics."""
    import jax.numpy as jnp

    from traffic_sign_detector.models.rec_pipeline import (
        grow_boxes_xyxy,
    )

    boxes = jnp.asarray([
        [10.0, 20.0, 30.0, 40.0],   # interior box
        [0.0, 0.0, 20.0, 20.0],     # corner box: grow clips at 0
        [90.0, 90.0, 99.0, 99.0],   # near far edge: clips at W/H
        [5.0, 5.0, 6.0, 6.0],       # degenerate (w < 2): dropped
    ])
    valid = jnp.asarray([True, True, True, True])
    out, keep = grow_boxes_xyxy(boxes, valid, 1.15, (100, 100))
    out = np.asarray(out)
    assert bool(keep[0]) and bool(keep[1]) and bool(keep[2])
    assert not bool(keep[3])
    # interior: grown by 1.15 about center (20, 30): w 20 -> 23
    x1, y1, x2, y2 = out[0]
    assert x2 - x1 in (22, 23) and y2 - y1 in (22, 23)
    assert x1 < 10 and x2 > 30
    # clipping stays in-frame
    assert (out[:3] >= 0).all() and (out[:3, [0, 2]] <= 100).all() \
        and (out[:3, [1, 3]] <= 100).all()


@pytest.mark.slow
def test_recognize_batch_cnn_smoke():
    """CNN-proposal recognition: planted peak -> grown crop -> classifier."""
    import jax
    import jax.numpy as jnp

    from traffic_sign_detector.models import cnn_detector as cd
    from traffic_sign_detector.models.rec_pipeline import (
        RecognitionPipeline,
    )

    # tiny v3 detector with head-bias surgery so decode emits valid boxes
    ccfg = cd.CNNDetectorConfig(arch="v3", max_detections=8,
                                score_threshold=0.5)
    p = dict(cd.init_params(0))
    p["Conv_4"] = {"kernel": p["Conv_4"]["kernel"],
                   "bias": p["Conv_4"]["bias"] + 8.0}
    p["Conv_5"] = {"kernel": p["Conv_5"]["kernel"] * 0.0,
                   "bias": p["Conv_5"]["bias"] + 1.5}   # 24 px boxes
    det = cd.CNNDetector(p, ccfg)

    clf = fit_classifier(_features(d=324), ClassifierConfig.from_string(
        "HOG_LDA_LDABAYES"))
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(mser=MSERConfig(), max_detections=8,
                           batch_size=2),
        classifier=clf,
        cnn=det,
    )
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    dets = pipe.recognize_frames(frames, ["a.jpg", "b.jpg"])
    for d in dets:
        assert 1 <= d.class_id <= 6
        assert 0.0 <= d.score <= 1.0
        assert 0 <= d.x1 < d.x2 <= 64 and 0 <= d.y1 < d.y2 <= 64
