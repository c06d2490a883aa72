"""Accelerator traffic-sign detection & recognition framework.

A ground-up JAX/XLA re-design of the capabilities of
cfkr-dev/OpenCV-Traffic-Sign-Detector (GTSDB traffic-sign detection via MSER
region proposals + mask-correlation / HOG+LDA recognition):

* batched, fixed-shape, on-device pipelines (`[B,H,W,3] -> padded proposals
  -> crops -> scores`) instead of per-image Python loops;
* fused XLA ops for the preprocessing, CLAHE, MSER-CCL, HOG and histogram
  stages, and a CUDA kernel for the MSER refinement flood;
* `jax.sharding`-based data parallelism over device meshes;
* host-side layers (dataset IO, serialization, PASCAL AP evaluation) kept
  format-compatible with the reference artifacts (gt.txt / resultado.txt).
"""

__version__ = "0.1.0"

from . import constants
from .config import ClassifierConfig, MSERConfig, PipelineConfig

__all__ = [
    "constants",
    "ClassifierConfig",
    "MSERConfig",
    "PipelineConfig",
    "__version__",
]
