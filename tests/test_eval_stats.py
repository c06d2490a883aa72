"""Statistics-engine parity: the reference run with MSER_7_200_2000_1 printed
totals 65 correct / 605 incorrect / 112 non-detected / 177 expected and
P=0.1, R=0.37, F1=0.15 (captured from a live run of the reference)."""

import math

import pytest

from traffic_sign_detector.data.gt import load_results_file
from traffic_sign_detector.eval.stats import (
    TypeCounts,
    box_match_score,
    compute_detection_statistics,
    sigmoid_distance_similarity,
)


def test_sigmoid_similarity_limits():
    assert sigmoid_distance_similarity(5, 5, 5, 5) == 1.0
    near = sigmoid_distance_similarity(0, 0, 1, 0)
    mid = sigmoid_distance_similarity(0, 0, 60, 0)
    far = sigmoid_distance_similarity(0, 0, 500, 0)
    assert near > 0.99
    assert near > mid > far
    assert far < 0.1


def test_box_match_score_geometric_mean():
    a = (10, 10, 50, 50)
    assert box_match_score(a, a) == 1.0
    s = box_match_score(a, (12, 10, 50, 52))
    assert 0.9 < s <= 1.0
    assert box_match_score(a, (200, 200, 400, 400)) < 0.2


def test_stats_totals_match_reference_run(fixtures_dir):
    dets = load_results_file(
        str(fixtures_dir / "ref_resultado_MSER_7_200_2000_1.txt")
    )
    stats = compute_detection_statistics(
        dets, str(fixtures_dir / "gt_test.txt")
    )
    assert stats.total.correct == 65
    assert stats.total.incorrect == 605
    assert stats.total.non_detected == 112
    assert stats.total.expected == 177
    assert stats.total.precision == pytest.approx(0.1)
    assert stats.total.recall == pytest.approx(0.37)
    assert stats.total.f1 == pytest.approx(0.15)


def test_typecounts_nan_when_empty():
    c = TypeCounts()
    assert math.isnan(c.precision) and math.isnan(c.recall) and math.isnan(c.f1)


def test_full_dataset_parity_artifact(fixtures_dir):
    """Regression pin: the device pipeline's full-run artifact holds reference
    parity (F1 0.15 vs 0.15) under the reference's own statistics engine."""
    ours = load_results_file(str(fixtures_dir / "ours_resultado_ds2.txt"))
    stats = compute_detection_statistics(ours, str(fixtures_dir / "gt_test.txt"))
    assert stats.total.f1 >= 0.17
    assert stats.total.precision >= 0.09
    assert stats.total.recall >= 0.33
    assert len(ours) > 500


def test_detection_artifact_r3(fixtures_dir):
    """Round-3 regression pin: the shipped CLI defaults' full-run artifact
    (ds=2, iters 2, step 9, 128 regions, batch 32).  Measured at pin time:
    281 dets, P 0.18 / R 0.28 / F1 0.22, AP 0.0698 — beats the reference
    (F1 0.15 / AP 0.043) and doubles r2's precision/AP at 3.3x its speed."""
    ours = load_results_file(str(fixtures_dir / "ours_resultado_r3.txt"))
    stats = compute_detection_statistics(ours, str(fixtures_dir / "gt_test.txt"))
    assert stats.total.f1 >= 0.21
    assert stats.total.precision >= 0.17
    assert stats.total.recall >= 0.26
    assert stats.total.correct >= 48


def test_recognition_artifact_r3(fixtures_dir):
    """Round-3 regression pin: recognition test-set artifact trained with
    proposal-matched positives + the (1.15, 1.3) grow union
    (HOG_LDA_LDABAYES, ds=2, iters=24 mining).  Measured at pin time:
    P 0.91 / R 0.35 / F1 0.51, AP 0.299 — the reference ships this path
    disabled; quality bar is the instructor's práctica-2 file
    (P 0.74 / R 0.74)."""
    ours = load_results_file(
        str(fixtures_dir / "ours_rec_resultado_r3.txt")
    )
    stats = compute_detection_statistics(ours, str(fixtures_dir / "gt_test.txt"))
    assert stats.total.f1 >= 0.50
    assert stats.total.precision >= 0.85
    assert stats.total.recall >= 0.33
    assert stats.total.correct >= 60


def test_full_dataset_parity_artifact_r2(fixtures_dir):
    """Round-2 regression pin: the shipped tuned config's full-run artifact
    (auto step 7, iters 8, scan refine) beats the reference on F1/P/R under
    the reference's own statistics engine."""
    ours = load_results_file(str(fixtures_dir / "ours_resultado_r2.txt"))
    stats = compute_detection_statistics(ours, str(fixtures_dir / "gt_test.txt"))
    assert stats.total.f1 >= 0.21
    assert stats.total.precision >= 0.14
    assert stats.total.recall >= 0.37
    assert stats.total.correct >= 65


def test_cnn_detection_artifact_r3(fixtures_dir):
    """Round-3 regression pin: the CNN center-point flagship (slim arch) at
    the shipped 0.50 threshold (artifact from scripts/train_cnn.py
    --arch slim, 24000 steps / 319 s on one chip).  Measured at pin time:
    133 dets, P 0.96 / R 0.72 / F1 0.83, AP 0.8717 (AP-max 0.9114 at thr
    0.2) — beats the instructor golden (AP 0.664), the MSER parity
    pipeline (F1 0.215 / AP 0.070), and the reference (F1 0.15 /
    AP 0.043) at 16x the parity pipeline's speed."""
    ours = load_results_file(
        str(fixtures_dir / "ours_cnn_resultado.txt"))
    stats = compute_detection_statistics(ours, str(fixtures_dir / "gt_test.txt"))
    assert stats.total.f1 >= 0.81
    assert stats.total.precision >= 0.92
    assert stats.total.recall >= 0.70
    assert stats.total.correct >= 125

    from traffic_sign_detector.eval.ap import (
        precision_recall_curve,
        pr_from_tp_fp,
    )
    from traffic_sign_detector.data.gt import load_ground_truth

    gt = load_ground_truth(str(fixtures_dir / "gt_test.txt"))
    tp, fp, _t, n_gt = precision_recall_curve(gt, ours)
    _r, _p, ap, _ap11 = pr_from_tp_fp(tp, fp, n_gt)
    assert ap >= 0.80
