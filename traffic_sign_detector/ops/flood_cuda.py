"""The refinement flood as a CUDA kernel behind ``jax.ffi``.

``ops/cuda/flood_bbox.cu`` holds one 128x128 window (mask + reached flags)
in a block's shared memory and resolves its mask runs there, so each
window is read from device memory once.  The shared library is built from
that source with ``nvcc`` on first use into ``<checkout>/build/`` (rebuilt
when the source is newer) and registered for the CUDA platform only; on
other platforms ``ops/mser.py`` lowers the plain scan flood, which is also
the reference the kernel is tested against.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.compile_cache import CHECKOUT

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                    "flood_bbox.cu")
LIB = os.path.join(CHECKOUT, "build", "libtsd_flood.so")
_TARGET = "tsd_flood_bbox"


def build_library() -> str:
    """Compile the kernel for sm_90a into ``LIB`` (if stale); return it."""
    if (os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(_SRC)):
        return LIB
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [os.path.join(cuda, "bin", "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, LIB)
    return LIB


@functools.cache
def available() -> bool:
    """Build and register the kernel when this process has a CUDA device.

    Registration is per process; a build failure on a CUDA machine raises
    (the kernel is part of the product path there).
    """
    try:
        if not jax.devices("cuda"):
            return False
    except RuntimeError:  # no CUDA backend in this process
        return False
    lib = ctypes.cdll.LoadLibrary(build_library())
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.TsdFloodBbox),
                                platform="CUDA")
    return True


def flood_bbox_cuda(mask: jax.Array, seeds_yx: jax.Array, *, big: int,
                    passes: int):
    """[..., H, W] bool mask + [..., 2] int32 seeds -> (ymin, ymax, xmin,
    xmax, area), each int32 [...]; H, W <= 128."""
    lead = mask.shape[:-2]
    out = jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct(lead + (5,), jnp.int32),
        vmap_method="broadcast_all",
    )(mask.astype(jnp.uint8), seeds_yx.astype(jnp.int32),
      passes=np.int32(passes), big=np.int32(big))
    return tuple(out[..., i] for i in range(5))
