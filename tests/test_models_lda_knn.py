"""LDA/KNN numerical parity vs sklearn on realistic feature data."""

import numpy as np
import pytest

from traffic_sign_detector.models.knn import knn_fit, knn_predict
from traffic_sign_detector.models.lda import (
    LDAParams,
    lda_fit,
    lda_predict_proba,
    lda_transform,
)


@pytest.fixture(scope="module")
def binary_data():
    rng = np.random.default_rng(10)
    n0, n1, d = 300, 120, 64
    x0 = rng.normal(0.0, 1.0, (n0, d))
    x1 = rng.normal(0.6, 1.1, (n1, d))
    X = np.concatenate([x0, x1]).astype(np.float32)
    y = np.concatenate([np.zeros(n0), np.full(n1, 3.0)])
    return X, y


@pytest.fixture(scope="module")
def multi_data():
    rng = np.random.default_rng(11)
    d, per = 48, 80
    Xs, ys = [], []
    for c in range(7):
        center = rng.normal(0, 1.5, d)
        Xs.append(center + rng.normal(0, 1.0, (per, d)))
        ys.append(np.full(per, c))
    return np.concatenate(Xs).astype(np.float32), np.concatenate(ys)


def test_binary_predict_proba_matches_sklearn(binary_data):
    sklearn_da = pytest.importorskip("sklearn.discriminant_analysis")
    X, y = binary_data
    ref = sklearn_da.LinearDiscriminantAnalysis().fit(X, y)
    ours = lda_fit(X, y)
    np.testing.assert_array_equal(ours.classes, ref.classes_)
    p_ref = ref.predict_proba(X)
    p_ours = np.asarray(lda_predict_proba(ours, X))
    np.testing.assert_allclose(p_ours, p_ref, atol=2e-4)


def test_multiclass_proba_and_transform_match_sklearn(multi_data):
    sklearn_da = pytest.importorskip("sklearn.discriminant_analysis")
    X, y = multi_data
    ref = sklearn_da.LinearDiscriminantAnalysis().fit(X, y)
    ours = lda_fit(X, y)

    p_ref = ref.predict_proba(X)
    p_ours = np.asarray(lda_predict_proba(ours, X))
    np.testing.assert_allclose(p_ours, p_ref, atol=2e-4)

    t_ref = ref.transform(X)
    t_ours = np.asarray(lda_transform(ours, X))
    assert t_ours.shape == t_ref.shape
    # axes are defined up to sign; compare with per-column sign alignment
    for j in range(t_ref.shape[1]):
        sign = np.sign(np.dot(t_ref[:, j], t_ours[:, j])) or 1.0
        np.testing.assert_allclose(
            t_ours[:, j] * sign, t_ref[:, j], atol=5e-3 * max(1, np.abs(t_ref[:, j]).max())
        )


def test_lda_on_real_hog_descriptors(train_frames_dir):
    """Binary sign-vs-background LDA on real HOG features, sklearn parity."""
    sklearn_da = pytest.importorskip("sklearn.discriminant_analysis")
    cv2 = pytest.importorskip("cv2")
    import os

    from traffic_sign_detector.ops.hog import hog_descriptors

    crops, labels = [], []
    for d, lab in (("14", 3.0), ("38", 6.0)):
        droot = os.path.join(str(train_frames_dir), d)
        for f in sorted(os.listdir(droot))[:40]:
            img = cv2.imread(os.path.join(droot, f))
            g = cv2.cvtColor(cv2.resize(img, (32, 32)), cv2.COLOR_BGR2GRAY)
            crops.append(g)
            labels.append(lab)
    X = np.asarray(hog_descriptors(np.stack(crops)))
    y = np.array(labels)
    ref = sklearn_da.LinearDiscriminantAnalysis().fit(X, y)
    ours = lda_fit(X, y)
    np.testing.assert_allclose(
        np.asarray(lda_predict_proba(ours, X)), ref.predict_proba(X), atol=1e-3
    )


def test_knn_matches_sklearn(multi_data):
    neighbors = pytest.importorskip("sklearn.neighbors")
    X, y = multi_data
    rng = np.random.default_rng(12)
    Xq = X + rng.normal(0, 0.3, X.shape).astype(np.float32)
    ref = neighbors.KNeighborsClassifier(n_neighbors=4).fit(X, y)
    ours = knn_fit(X, y, k=4)
    p_ref = ref.predict(Xq)
    p_ours = np.asarray(knn_predict(ours, Xq))
    # distance ties at float precision can flip the 4th neighbour; demand
    # near-total agreement rather than bit equality
    assert (p_ref == p_ours).mean() > 0.99


def test_lda_params_roundtrip(tmp_path, binary_data):
    X, y = binary_data
    params = lda_fit(X, y)
    p = str(tmp_path / "lda.npz")
    params.save(p)
    loaded = LDAParams.load(p)
    np.testing.assert_array_equal(loaded.coef, params.coef)
    np.testing.assert_allclose(
        np.asarray(lda_predict_proba(loaded, X[:10])),
        np.asarray(lda_predict_proba(params, X[:10])),
    )
