"""CLI surface tests: grammar handling and the evaluation script."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, *args):
    # CLI subprocesses stay on the CPU backend (one JAX process per card)
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT)}
    if "HOME" in os.environ:
        env["HOME"] = os.environ["HOME"]
    return subprocess.run(
        [sys.executable, script, *args],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=str(ROOT),
    )


def test_detection_cli_rejects_bad_spec():
    r = _run("main_detection.py", "--detector", "MSER_0_200_2000_0.5")
    assert r.returncode == 2
    assert "MSER_<delta>" in r.stdout


def test_recognition_cli_rejects_bad_spec():
    r = _run("main_recognition.py", "--classifier", "SIFT_PCA_SVM")
    assert r.returncode == 2
    assert "Invalid spec" in r.stdout


def test_evaluate_results_cli(fixtures_dir, test_frames_dir):
    r = _run(
        "evaluate_results.py",
        "--test_path", str(test_frames_dir),
        "--detections_file", str(fixtures_dir / "instructor_practica2.txt"),
        "--compare", str(fixtures_dir / "ref_resultado_MSER_7_200_2000_1.txt"),
        "--no_golden",
    )
    assert r.returncode == 0, r.stderr
    assert "AP=74.2" in r.stdout
    assert "AP=4.3" in r.stdout


def test_evaluate_results_overlays_goldens_by_default(fixtures_dir,
                                                      test_frames_dir):
    # reference behaviour: both instructor curves are scored automatically
    # (`Reconocimiento de Objetos/evaluar_resultados.py:333-371`)
    r = _run(
        "evaluate_results.py",
        "--test_path", str(test_frames_dir),
        "--detections_file", str(fixtures_dir / "instructor_practica2.txt"),
    )
    assert r.returncode == 0, r.stderr
    assert "AP=66.4" in r.stdout  # práctica-1 golden
    assert r.stdout.count("AP=74.2") == 2  # student file + práctica-2 golden


def test_detection_cli_stage_failure_is_isolated(tmp_path):
    # An unreadable train path must produce the stage banner and exit 1
    # without a traceback (reference: DET/source.py:618-626 banners).
    r = _run("main_detection.py", "--train_path", str(tmp_path / "nope"),
             "--test_path", str(tmp_path / "nope"))
    assert r.returncode == 1
    assert "STAGE FAILED (train mean-mask templates)" in r.stdout
    assert "Traceback" not in r.stdout + r.stderr


def test_evaluate_results_draw_dir(fixtures_dir, test_frames_dir, tmp_path):
    # --draw_dir writes GT(green)/detection(red) overlay frames, the
    # reference scorer's BoundingBox drawing (evaluar_resultados.py:36-49)
    out = tmp_path / "ov"
    r = _run(
        "evaluate_results.py",
        "--test_path", str(test_frames_dir),
        "--detections_file", str(fixtures_dir / "instructor_practica2.txt"),
        "--no_golden", "--draw_dir", str(out),
    )
    assert r.returncode == 0, r.stderr
    assert "overlay frames written" in r.stdout
    pngs = list(out.glob("*.png"))
    assert pngs, "no overlay images produced"


import pytest


@pytest.mark.slow
def test_recognition_cli_sweep_configs(tmp_path, mini_train_dir):
    # the reference's commented-out multi-config loop (main.py:96-103):
    # all four classifier configs validate and a summary table prints
    r = _run(
        "main_recognition.py", "--sweep_configs",
        "--train_path", str(mini_train_dir),
        "--cache", str(tmp_path / "c.npz"),
        "--model_out", str(tmp_path / "m"),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "== summary (validation accuracy) ==" in r.stdout
    for spec in ("HOG_LDA_BAYES", "HOG_LDA_KNN",
                 "GRAY_LDA_BAYES", "GRAY_LDA_KNN"):
        assert spec in r.stdout


def test_serve_detection_once(tmp_path, mini_train_dir):
    # streaming server surface: drain a directory once, emit JSONL with
    # per-frame latency + detections, print the latency report
    import numpy as np

    from traffic_sign_detector.models.mean_masks import (
        MeanMaskTemplates,
    )

    rng = np.random.default_rng(3)
    tmpl = tmp_path / "tmpl.npz"
    MeanMaskTemplates(
        red=(rng.random((6, 625)) < 0.3).astype(np.float32),
        blue=(rng.random((6, 625)) < 0.3).astype(np.float32),
    ).save(str(tmpl))
    out = tmp_path / "dets.jsonl"
    r = _run(
        "serve_detection.py",
        "--watch_dir", mini_train_dir,
        "--out", str(out),
        "--templates", str(tmpl),
        "--batch", "2", "--once", "--downscale", "1",
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "latency ms p50" in r.stdout
    import json as _json

    lines = [_json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 2  # both mini frames drained
    for rec in lines:
        assert set(rec) == {"file", "latency_ms", "detections"}
        for d in rec["detections"]:
            assert set(d) == {"box", "type", "score"}


def test_serve_detection_once_cnn(tmp_path, mini_train_dir):
    # the streaming server hosts the CNN flagship family too (shipped
    # weights; 256x256 mini frames satisfy the multiple-of-16 contract)
    out = tmp_path / "dets_cnn.jsonl"
    r = _run(
        "serve_detection.py",
        "--watch_dir", mini_train_dir,
        "--out", str(out),
        "--detector", "CNN_0.3",
        "--batch", "2", "--once",
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "latency ms p50" in r.stdout
    import json as _json

    lines = [_json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 2
    for rec in lines:
        assert set(rec) == {"file", "latency_ms", "detections"}


def test_serve_detection_rejects_bad_cnn_spec(tmp_path):
    r = _run(
        "serve_detection.py",
        "--watch_dir", str(tmp_path),
        "--detector", "CNN_x_y", "--once",
    )
    assert r.returncode == 2
    assert "CNN" in r.stdout


def test_detection_cli_rejects_bad_cnn_spec():
    r = _run("main_detection.py", "--detector", "CNN_1.5")
    assert r.returncode == 2
    assert "CNN" in r.stdout
    r = _run("main_detection.py", "--detector", "CNN_x_y")
    assert r.returncode == 2


def test_detection_cli_cnn_missing_weights_fails_cleanly(tmp_path):
    r = _run("main_detection.py", "--detector", "CNN",
             "--cnn_params", str(tmp_path / "nope.npz"),
             "--test_path", str(tmp_path))
    assert r.returncode == 1
    assert "STAGE FAILED" in r.stdout


@pytest.mark.slow
def test_detection_cli_cnn_end_to_end(tmp_path, test_frames_dir):
    import shutil as _shutil

    from traffic_sign_detector.models import cnn_detector as cd

    # the CLI builds the default-config model; save default-config params
    cd.save_params(str(tmp_path / "params.npz"),
                   cd.init_params(0))
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    names = sorted(p.name for p in test_frames_dir.glob("*.jpg"))[:2]
    for n in names:
        _shutil.copy(test_frames_dir / n, frames_dir / n)
    gt_src = (test_frames_dir / "gt.txt").read_text().splitlines()
    keep = [l for l in gt_src if l.split(";")[0].split(".")[0] + ".jpg" in names]
    (frames_dir / "gt.txt").write_text("\n".join(keep) + "\n")

    out = tmp_path / "resultado.txt"
    r = _run("main_detection.py", "--detector", "CNN_0.9",
             "--cnn_params", str(tmp_path / "params.npz"),
             "--test_path", str(frames_dir), "--batch_size", "2",
             "--out", str(out), "--no-images")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASCAL AP@0.5" in r.stdout
    assert out.exists()
    # untrained prior ~0.01 << 0.9 threshold: no detections, but the full
    # stage pipeline (load -> detect -> serialize -> stats) must succeed
    assert out.read_text().strip() == ""


def test_detection_cli_rejects_bad_upscale():
    r = _run("main_detection.py", "--detector", "CNN", "--upscale", "0")
    assert r.returncode == 2
    assert "must be > 0" in r.stdout


def test_detection_cli_rejects_upscale_with_patches8():
    r = _run("main_detection.py", "--detector", "CNN",
             "--upscale", "1.412", "--input_format", "patches8")
    assert r.returncode == 2
    assert "patches8" in r.stdout


def test_serve_cli_rejects_upscale_without_cnn(tmp_path):
    r = _run("serve_detection.py", "--watch_dir", str(tmp_path),
             "--detector", "MSER_7_200_2000_1", "--upscale", "1.5",
             "--once")
    assert r.returncode == 2
    assert "--upscale requires" in r.stdout


def test_recognition_proposals_auto_default():
    """--proposals defaults to 'auto': CNN when the flagship weights exist
    (the golden-beating recipe is the default CLI behavior),
    MSER parity fallback otherwise."""
    import argparse
    import os

    import main_recognition as mr

    ns = argparse.Namespace(
        proposals="auto",
        cnn_params="/nonexistent/params.npz")
    assert mr._parse_cnn_proposals(ns) is None  # falls back to MSER

    real = "artifacts/cnn_detector/params.npz"
    if not os.path.exists(real):
        return
    ns = argparse.Namespace(proposals="auto", cnn_params=real)
    det = mr._parse_cnn_proposals(ns)
    assert det is not None
    assert ns.proposals == "CNN"
    assert abs(det.cfg.score_threshold - 0.10) < 1e-9

    ns = argparse.Namespace(proposals="MSER", cnn_params=real)
    assert mr._parse_cnn_proposals(ns) is None
