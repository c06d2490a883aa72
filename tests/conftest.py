"""Test configuration: a deterministic 8-device CPU JAX platform.

Sharding tests run on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count), so multi-device code paths are
exercised without accelerators.  Must be set before jax is first imported.

``TSD_GPU_TESTS=1`` leaves JAX's default backend in place instead, for the
``gpu``-marked tests on a machine with a card (see README.md); those tests
skip, with a reason, wherever no CUDA device is present.
"""

import os

GPU_LANE = bool(os.environ.get("TSD_GPU_TESTS"))

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REFERENCE_ROOT = pathlib.Path("/root/reference")
DET_DATA = REFERENCE_ROOT / "Deteción de Objetos"
REC_DATA = REFERENCE_ROOT / "Reconocimiento de Objetos"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture(scope="session")
def test_frames_dir() -> pathlib.Path:
    d = DET_DATA / "test_alumnos_jpg"
    if not d.is_dir():
        pytest.skip("reference GTSDB test frames not available")
    return d


@pytest.fixture(scope="session")
def train_frames_dir() -> pathlib.Path:
    d = DET_DATA / "train_jpg"
    if not d.is_dir():
        pytest.skip("reference GTSDB train frames not available")
    return d


def require_cv2():
    """Oracle-only dependency: several kernel tests compare against OpenCV."""
    return pytest.importorskip("cv2")


@pytest.fixture(scope="session")
def mini_train_dir(tmp_path_factory) -> str:
    """Tiny synthetic train dir (2 frames + gt.txt) for CLI-level tests."""
    import numpy as np
    from PIL import Image

    root = tmp_path_factory.mktemp("mini_train_cli")
    rng = np.random.default_rng(7)
    gt_lines = []
    for i in range(2):
        img = rng.integers(90, 140, (256, 256, 3), np.uint8)
        x, y = 40 + 60 * i, 80
        img[y : y + 30, x : x + 30] = (20, 20, 180)  # reddish sign square
        img[190:218, 170:198] = (25, 25, 25)  # negative-mining decoy
        Image.fromarray(img[..., ::-1]).save(root / f"{i:05d}.jpg")
        gt_lines.append(f"{i:05d}.ppm;{x};{y};{x + 30};{y + 30};14")
    (root / "gt.txt").write_text("\n".join(gt_lines) + "\n")
    return str(root)
