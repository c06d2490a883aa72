"""AP protocol parity: oracle numbers computed once with the instructor's
scoring implementation (filenames normalised to .jpg stems on both sides).
"""

import numpy as np
import pytest

from traffic_sign_detector.eval.ap import (
    average_precision_11pt,
    average_precision_voc,
    pr_from_tp_fp,
    precision_recall_curve,
    score_detection_files,
)


@pytest.mark.parametrize(
    "fixture, expected_ap, expected_ap11",
    [
        ("ref_resultado_MSER_7_200_2000_1.txt", 0.043142, 0.04356),
        ("instructor_practica1.txt", 0.663531, 0.651833),
        ("instructor_practica2.txt", 0.741674, 0.69478),
    ],
)
def test_ap_matches_instructor_protocol(fixtures_dir, fixture, expected_ap, expected_ap11):
    res = score_detection_files(
        str(fixtures_dir / fixture), str(fixtures_dir / "gt_test.txt")
    )
    assert res["n_gt"] == 146  # 177 rows - 31 ignore regions
    assert res["ap"] == pytest.approx(expected_ap, abs=1e-5)
    assert res["ap_11pt"] == pytest.approx(expected_ap11, abs=1e-5)


def test_voc_ap_simple():
    rec = np.array([0.5, 1.0])
    prec = np.array([1.0, 0.5])
    assert average_precision_voc(rec, prec) == pytest.approx(0.75)
    assert average_precision_11pt(rec, prec) == pytest.approx(
        (6 * 1.0 + 5 * 0.5) / 11
    )


def test_pr_curve_ignore_regions(fixtures_dir):
    from traffic_sign_detector.data.gt import (
        GroundTruthBox,
        load_ground_truth,
    )

    gt = load_ground_truth(str(fixtures_dir / "gt_test.txt"))
    ignore = [g for g in gt if g.class_id == -1][0]
    # a detection exactly on an ignore region is neither TP nor FP
    det = [
        GroundTruthBox(
            filename=ignore.filename,
            x1=ignore.x1,
            y1=ignore.y1,
            x2=ignore.x2,
            y2=ignore.y2,
            class_id=1,
            score=0.9,
        )
    ]
    tp, fp, _thr, n_gt = precision_recall_curve(gt, det)
    assert tp.sum() == 0 and fp.sum() == 0
    rec, prec, ap, _ = pr_from_tp_fp(tp, fp, n_gt)
    assert ap == 0.0
