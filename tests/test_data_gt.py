from traffic_sign_detector.constants import supertype_of
from traffic_sign_detector.data.gt import (
    boxes_by_file,
    load_ground_truth,
    load_results_file,
)


def test_supertype_mapping():
    assert supertype_of(0) == 1
    assert supertype_of(16) == 1
    assert supertype_of(11) == 2
    assert supertype_of(31) == 2
    assert supertype_of(14) == 3
    assert supertype_of(17) == 4
    assert supertype_of(13) == 5
    assert supertype_of(38) == 6
    assert supertype_of(6) is None  # de-restriction: unmapped
    assert supertype_of(42) is None


def test_load_test_gt(fixtures_dir):
    boxes = load_ground_truth(str(fixtures_dir / "gt_test.txt"))
    assert len(boxes) == 177
    assert sum(1 for b in boxes if b.class_id == -1) == 31
    assert all(b.filename.endswith(".jpg") for b in boxes)
    # every mapped class in 1..6
    assert {b.class_id for b in boxes} <= {-1, 1, 2, 3, 4, 5, 6}


def test_load_train_gt_dropping(fixtures_dir):
    kept = load_ground_truth(str(fixtures_dir / "gt_train.txt"), drop_unmapped=True)
    all_rows = load_ground_truth(str(fixtures_dir / "gt_train.txt"))
    assert len(all_rows) == 852
    assert len(kept) < 851
    assert all(b.class_id in (1, 2, 3, 4, 5, 6) for b in kept)


def test_load_results_file(fixtures_dir):
    dets = load_results_file(str(fixtures_dir / "ref_resultado_MSER_7_200_2000_1.txt"))
    assert len(dets) == 670
    assert all(0.0 <= d.score <= 1.0 for d in dets)
    grouped = boxes_by_file(dets)
    assert all(k.endswith(".jpg") for k in grouped)
