"""Device statistics vs the host engine, plus mesh psum totals."""

import numpy as np

from traffic_sign_detector.data.gt import GroundTruthBox, load_results_file
from traffic_sign_detector.data.gt import load_ground_truth
from traffic_sign_detector.eval.device_stats import (
    distributed_statistics,
    frame_type_counts,
)
from traffic_sign_detector.eval.stats import compute_detection_statistics
from traffic_sign_detector.parallel.mesh import data_mesh, shard_batch


def _pad_frame(dets, gts, d_cap=32, g_cap=16):
    db = np.zeros((d_cap, 4), np.int32)
    dt = np.zeros((d_cap,), np.int32)
    dv = np.zeros((d_cap,), bool)
    for i, d in enumerate(dets[:d_cap]):
        db[i] = (d.x1, d.y1, d.x2, d.y2)
        dt[i] = d.class_id
        dv[i] = True
    gb = np.zeros((g_cap, 4), np.int32)
    gt = np.zeros((g_cap,), np.int32)
    for i, g in enumerate(gts[:g_cap]):
        gb[i] = (g.x1, g.y1, g.x2, g.y2)
        gt[i] = g.class_id
    return db, dt, dv, gb, gt


def test_device_counts_match_host_engine(fixtures_dir):
    dets = load_results_file(str(fixtures_dir / "ref_resultado_MSER_7_200_2000_1.txt"))
    gt = load_ground_truth(str(fixtures_dir / "gt_test.txt"))
    gt = [g for g in gt if g.class_id != -1]

    frames = sorted({d.filename for d in dets} | {g.filename for g in gt})
    per_frame = []
    for f in frames:
        per_frame.append(_pad_frame(
            [d for d in dets if d.filename == f],
            [g for g in gt if g.filename == f],
        ))
    batch = [np.stack(x) for x in zip(*per_frame)]

    c = np.zeros(6, np.int64)
    i = np.zeros(6, np.int64)
    m = np.zeros(6, np.int64)
    for k in range(len(frames)):
        cc, ii, mm = frame_type_counts(*(b[k] for b in batch))
        c += np.asarray(cc)
        i += np.asarray(ii)
        m += np.asarray(mm)

    host = compute_detection_statistics(dets, gt, unmapped_as_type6=False)
    host_c = np.array([host.per_type[t].correct for t in host.per_type])
    host_i = np.array([host.per_type[t].incorrect for t in host.per_type])
    host_m = np.array([host.per_type[t].non_detected for t in host.per_type])
    np.testing.assert_array_equal(c, host_c)
    np.testing.assert_array_equal(i, host_i)
    np.testing.assert_array_equal(m, host_m)


def test_distributed_statistics_psum(fixtures_dir):
    rng = np.random.default_rng(0)
    B, D, G = 8, 16, 8
    db = rng.integers(0, 700, (B, D, 4)).astype(np.int32)
    db[..., 2:] = db[..., :2] + rng.integers(20, 60, (B, D, 2))
    dt = rng.integers(1, 7, (B, D)).astype(np.int32)
    dv = rng.random((B, D)) < 0.5
    # half the GT overlaps detections exactly -> guaranteed corrects
    gb = db[:, :G].copy()
    gt = np.where(rng.random((B, G)) < 0.7, dt[:, :G], 0).astype(np.int32)

    mesh = data_mesh()
    fn = distributed_statistics(mesh)
    c, i, m = fn(*(shard_batch(mesh, x) for x in (db, dt, dv, gb, gt)))

    # replicate with the single-device path
    cc = np.zeros(6, np.int64)
    ii = np.zeros(6, np.int64)
    mm = np.zeros(6, np.int64)
    for k in range(B):
        a, b_, c_ = frame_type_counts(db[k], dt[k], dv[k], gb[k], gt[k])
        cc += np.asarray(a)
        ii += np.asarray(b_)
        mm += np.asarray(c_)
    np.testing.assert_array_equal(np.asarray(c), cc)
    np.testing.assert_array_equal(np.asarray(i), ii)
    np.testing.assert_array_equal(np.asarray(m), mm)
