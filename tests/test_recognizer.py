"""Recognition stack: classifier fit/predict, arbitration, harness pieces.

Full 600-frame training is an accelerator job; these tests exercise every component
on synthetic data plus a miniature end-to-end run over tiny synthetic frames.
"""

import os

import numpy as np
import pytest

from traffic_sign_detector.config import ClassifierConfig, MSERConfig
from traffic_sign_detector.eval.reports import (
    classification_report,
    confusion_matrix,
)
from traffic_sign_detector.models.recognizer import (
    SignClassifier,
    arbitrate_lda_heads,
    build_training_data,
    compute_features,
    fit_classifier,
    predict_classifier,
    run_validation,
    split_validation,
)


def _synthetic_features(seed=0, per=60, d=32):
    """Orthogonal class signatures: each class lights up its own dimension.

    One-vs-background LDA heads are only selective when the classes differ
    along distinct directions (with shared random centers every head fires on
    every sign, and the reference's first-head-wins arbitration collapses to
    the lowest type — faithful, but useless as a separability probe).
    """
    rng = np.random.default_rng(seed)
    feats = {}
    for c in range(7):
        center = np.zeros(d)
        if c > 0:
            center[c] = 5.0
        feats[c] = (center + rng.normal(0, 0.7, (per, d))).astype(np.float32)
    return feats


def test_split_validation_ordered():
    data = {c: np.arange(20 * (c + 1)).reshape(-1, 1, 1) for c in range(7)}
    train, val = split_validation(data, 0.1)
    for c in range(7):
        n = len(data[c])
        n_val = int(np.ceil(n * 0.1))
        assert len(val[c]) == n_val
        assert len(train[c]) == n - n_val
        np.testing.assert_array_equal(val[c], data[c][-n_val:])


def test_ldabayes_fit_predict_separable():
    feats = _synthetic_features()
    clf = fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_LDABAYES"))
    assert clf.heads is not None and len(clf.heads) == 6
    X = np.concatenate([feats[c] for c in range(7)])
    y = np.concatenate([np.full(len(feats[c]), c) for c in range(7)])
    pred = predict_classifier(clf, X, no_sign_tol=0.5)
    assert (pred == y).mean() > 0.9


def test_knn_fit_predict_separable():
    feats = _synthetic_features(seed=1)
    clf = fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_KNN"))
    assert clf.reducer is not None and clf.knn is not None
    X = np.concatenate([feats[c] for c in range(7)])
    y = np.concatenate([np.full(len(feats[c]), c) for c in range(7)])
    pred = predict_classifier(clf, X)
    assert (pred == y).mean() > 0.95


def test_arbitration_rules():
    # probs[head, instance, (background, sign)]
    probs = np.zeros((6, 4, 2), np.float32)
    # instance 0: every head says background -> 0
    probs[:, 0] = (0.9, 0.1)
    # instance 1: head 2 (type 3) asserts sign confidently
    probs[:, 1] = (0.8, 0.2)
    probs[2, 1] = (0.1, 0.9)
    # instance 2: heads 1 and 4 assert; head 4 more confident -> type 5
    probs[:, 2] = (0.7, 0.3)
    probs[1, 2] = (0.2, 0.8)
    probs[4, 2] = (0.05, 0.95)
    # instance 3: a head says sign but below tol; others background -> 0
    probs[:, 3] = (0.9, 0.1)
    probs[3, 3] = (0.55, 0.45)
    out = np.asarray(arbitrate_lda_heads(probs, tol=0.5))
    assert out.tolist() == [0, 3, 5, 0]


def test_arbitration_sign_margin_dial():
    """sign_margin=0 is exact parity; margin>0 lets p_sign in
    [0.5-margin, 0.5) assert a sign (the P/R dial the reference lacks)."""
    probs = np.zeros((6, 2, 2), np.float32)
    # instance 0: head 3 at p_sign 0.45 — background at parity, sign
    # with margin 0.1
    probs[:, 0] = (0.9, 0.1)
    probs[3, 0] = (0.55, 0.45)
    # instance 1: clear background everywhere — margin must not flip it
    probs[:, 1] = (0.95, 0.05)
    assert np.asarray(
        arbitrate_lda_heads(probs, tol=0.5)
    ).tolist() == [0, 0]
    assert np.asarray(
        arbitrate_lda_heads(probs, tol=0.5, sign_margin=0.1)
    ).tolist() == [4, 0]


def test_arbitration_low_conf_sign_can_win_via_other_head():
    # reference quirk: once any head crosses tol, *all* sign-asserting heads
    # compete by confidence — even ones below tol
    probs = np.zeros((6, 1, 2), np.float32)
    probs[:, 0] = (0.9, 0.1)
    probs[0, 0] = (0.2, 0.8)   # head 1 asserts above tol
    probs[5, 0] = (0.01, 0.99)  # head 6 even more confident
    out = np.asarray(arbitrate_lda_heads(probs, tol=0.5))
    assert out.tolist() == [6]


def test_classifier_save_load_roundtrip(tmp_path):
    feats = _synthetic_features(seed=2)
    for spec in ("HOG_LDA_LDABAYES", "GRAY_LDA_KNN"):
        clf = fit_classifier(feats, ClassifierConfig.from_string(spec))
        p = str(tmp_path / spec)
        clf.save(p)
        loaded = SignClassifier.load(p)
        X = np.concatenate([feats[c][:5] for c in range(7)])
        np.testing.assert_array_equal(
            predict_classifier(loaded, X), predict_classifier(clf, X)
        )


def test_confusion_and_report_match_sklearn():
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(3)
    y_true = rng.integers(0, 7, 200)
    y_pred = np.where(rng.random(200) < 0.7, y_true, rng.integers(0, 7, 200))
    labels = list(range(7))
    ours = confusion_matrix(y_true, y_pred, labels)
    ref = metrics.confusion_matrix(y_true, y_pred, labels=labels)
    np.testing.assert_array_equal(ours, ref)
    # report smoke: parses and contains all class rows
    rep = classification_report(y_true, y_pred, labels,
                                target_names=[f"c{i}" for i in labels])
    assert all(f"c{i}" in rep for i in labels)


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    """Two tiny synthetic frames + gt.txt exercising the full data path."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mini_train")
    rng = np.random.default_rng(4)
    gt_lines = []
    for i in range(2):
        img = rng.integers(90, 140, (256, 256, 3), np.uint8)
        # a crisp dark "sign" square
        x, y = 40 + 60 * i, 80
        img[y : y + 30, x : x + 30] = (20, 20, 180)  # reddish BGR
        # a decoy dark blob far from the GT -> mined as a negative
        img[190:218, 170:198] = (25, 25, 25)
        Image.fromarray(img[..., ::-1]).save(root / f"{i:05d}.jpg")
        gt_lines.append(f"{i:05d}.ppm;{x};{y};{x + 30};{y + 30};14")
    (root / "gt.txt").write_text("\n".join(gt_lines) + "\n")
    return str(root)


@pytest.mark.slow
def test_build_training_data_mini(mini_dataset, tmp_path):
    cache = str(tmp_path / "proposals.npz")
    cfg = MSERConfig(max_variation=1.0, max_regions=128)
    data = build_training_data(mini_dataset, mser_cfg=cfg, cache_path=cache)
    assert set(data.keys()) == set(range(7))
    assert len(data[3]) == 2  # the two stop-sign GT boxes
    assert data[3].shape[1:] == (32, 32)
    assert len(data[0]) >= 1  # some negatives mined
    assert os.path.exists(cache)
    # cache reuse must give identical data
    data2 = build_training_data(mini_dataset, mser_cfg=cfg, cache_path=cache)
    np.testing.assert_array_equal(data[0], data2[0])


@pytest.mark.slow
def test_build_training_data_proposal_positives_and_grows(mini_dataset, tmp_path):
    """proposal_positives labels IoU>0.5 proposals with the GT class, and
    the cache tag distinguishes grow sets (no silent stale reuse)."""
    cache = str(tmp_path / "proposals_pp.npz")
    cfg = MSERConfig(max_variation=1.0, max_regions=128)
    base = build_training_data(mini_dataset, mser_cfg=cfg, cache_path=cache)
    pp = build_training_data(
        mini_dataset, mser_cfg=cfg, cache_path=cache,
        proposal_positives=True, grows=(1.15, 1.3),
    )
    # the synthetic sign square is a clean MSER component: the grown
    # proposal overlaps GT with IoU>0.5, so class 3 gains positives beyond
    # the two pixel-exact GT crops
    assert len(pp[3]) > len(base[3])
    assert pp[3].shape[1:] == (32, 32)
    # proposal-positives must never leak into the negatives
    assert len(pp[0]) <= len(base[0]) * 2 + 8
    # different grow set -> different cache tag -> regeneration, not reuse
    import numpy as _np

    z = _np.load(cache, allow_pickle=False)
    assert "g1.15,1.3" in str(z["tag"])


def test_compute_features_shapes():
    crops = np.random.default_rng(5).integers(0, 256, (6, 32, 32), np.uint8)
    assert compute_features(crops, "HOG").shape == (6, 324)
    assert compute_features(crops, "GRAY").shape == (6, 1024)
    assert compute_features(np.zeros((0, 32, 32), np.uint8), "HOG").shape == (0, 324)


def test_ldabayes_empty_class_heads(tmp_path):
    """Classes with zero positives (small --limit runs) must not crash the
    fit: their heads are None and always predict background."""
    rng = np.random.default_rng(3)
    feats = _synthetic_features(per=40)
    feats[3] = np.zeros((0, feats[0].shape[1]), np.float32)
    feats[4] = np.zeros((0, feats[0].shape[1]), np.float32)
    clf = fit_classifier(feats, ClassifierConfig())
    assert clf.heads[2] is None and clf.heads[3] is None

    X = np.concatenate([feats[0][:4], feats[1][:4]])
    pred = predict_classifier(clf, X)
    assert pred.shape == (8,)
    assert not np.any((pred == 3) | (pred == 4))

    path = str(tmp_path / "clf")
    clf.save(path)
    clf2 = SignClassifier.load(path)
    assert clf2.heads[2] is None and clf2.heads[3] is None
    np.testing.assert_array_equal(predict_classifier(clf2, X), pred)


@pytest.mark.slow
def test_run_validation_end_to_end_mini(mini_dataset, tmp_path):
    """Full validation harness on the synthetic mini dataset: mining ->
    split -> descriptors -> fit -> predict -> metrics, incl. classes with
    zero positives (None heads) and the recorded proposal spec."""
    cfg = MSERConfig(max_variation=1.0, max_regions=128)
    result = run_validation(
        mini_dataset,
        mser_cfg=cfg,
        clf_cfg=ClassifierConfig(),
        validation_pct=0.34,
        cache_path=str(tmp_path / "cache.npz"),
    )
    assert result.confusion.shape == (7, 7)
    assert 0.0 <= result.accuracy <= 1.0
    assert "NoSeñal" in result.report
    clf = result.classifier
    assert clf.proposal_spec is not None
    assert cfg.to_string() in clf.proposal_spec
    # mini dataset only has stop-sign positives: other heads are None
    assert clf.heads[2] is not None  # type 3 = STOP (index 2)
    assert any(h is None for h in clf.heads)
