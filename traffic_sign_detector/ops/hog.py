"""Batched HOG descriptors matching cv2.HOGDescriptor's 32x32 configuration.

Configuration (reference `Reconocimiento de Objetos/constants.py:14`):
window 32x32, block 16x16, stride 8x8, cell 8x8, 9 bins, signed gradients,
no gamma correction, Gaussian block weighting (winSigma = (16+16)/8 = 4),
trilinear cell/bin interpolation, L2-Hys normalization (clip 0.2) with
OpenCV's exact epsilon terms.  Descriptor: 3x3 blocks x 2x2 cells x 9 bins
= 324 floats.

The whole computation is dense tensor algebra: per-pixel soft bin votes
[N,32,32,9] contracted against a precomputed (Gaussian x bilinear) spatial
weight tensor [16,16,2,2] per block — i.e. HOG compiles to batched matmuls
on device, replacing the per-crop `hog.compute` calls
(`Reconocimiento de Objetos/source.py:487-521`).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    HOG_BLOCK_SIZE,
    HOG_CELL_SIZE,
    HOG_NBINS,
    HOG_WIN_SIZE,
)

_WIN = HOG_WIN_SIZE[0]
_BLK = HOG_BLOCK_SIZE[0]
_CELL = HOG_CELL_SIZE[0]
_STRIDE = 8
_NB = HOG_NBINS
_NBLOCKS = (_WIN - _BLK) // _STRIDE + 1  # 3 per axis
_CPB = _BLK // _CELL  # 2 cells per block axis


@functools.cache
def _spatial_weights() -> np.ndarray:
    """[16, 16, 2, 2] per-block-pixel weight to each of the 2x2 cells,
    Gaussian * bilinear, OpenCV conventions."""
    sigma = (HOG_BLOCK_SIZE[0] + HOG_BLOCK_SIZE[1]) / 8.0  # 4.0
    scale = 1.0 / (2.0 * sigma * sigma)
    w = np.zeros((_BLK, _BLK, _CPB, _CPB), np.float64)
    for i in range(_BLK):
        for j in range(_BLK):
            # OpenCV centers the Gaussian at blockSize*0.5 = (8, 8), NOT
            # at the pixel-center (7.5, 7.5) — hog.cpp HOGCache::init
            # `di = i - blockSize.height*0.5f`.  The +0.5 variant this
            # module originally used produced a systematic ~0.03 max
            # descriptor deviation, exposed the moment a true cv2 oracle
            # existed (tests/fixtures/cv2_hog_golden.npz, generated
            # against the system OpenCV 4.6 C++ HOGDescriptor).
            di = i - _BLK * 0.5
            dj = j - _BLK * 0.5
            gauss = math.exp(-(di * di + dj * dj) * scale)
            cy = (i + 0.5) / _CELL - 0.5
            cx = (j + 0.5) / _CELL - 0.5
            iy0 = math.floor(cy)
            ix0 = math.floor(cx)
            fy = cy - iy0
            fx = cx - ix0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = iy0 + dy, ix0 + dx
                    if 0 <= yy < _CPB and 0 <= xx < _CPB:
                        w[i, j, yy, xx] = gauss * wy * wx
    return w.astype(np.float32)


def _gradients(img: jnp.ndarray):
    """Central differences with reflect-101 borders on [..., 32, 32]."""
    f = img.astype(jnp.float32)
    left = jnp.concatenate([f[..., :, 1:2], f[..., :, :-1]], axis=-1)
    right = jnp.concatenate([f[..., :, 1:], f[..., :, -2:-1]], axis=-1)
    dx = right - left
    up = jnp.concatenate([f[..., 1:2, :], f[..., :-1, :]], axis=-2)
    down = jnp.concatenate([f[..., 1:, :], f[..., -2:-1, :]], axis=-2)
    dy = down - up
    return dx, dy


def hog_descriptors(crops: jnp.ndarray) -> jnp.ndarray:
    """[N, 32, 32] uint8 gray -> [N, 324] float32 descriptors."""
    dx, dy = _gradients(crops)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)  # [-pi, pi], signed gradients span 2*pi

    angle_scale = _NB / (2.0 * math.pi)
    fbin = ang * angle_scale - 0.5
    b0 = jnp.floor(fbin)
    w1 = fbin - b0
    b0i = jnp.mod(b0.astype(jnp.int32), _NB)
    b1i = jnp.mod(b0i + 1, _NB)

    bins = jnp.arange(_NB, dtype=jnp.int32)
    votes = mag[..., None] * (
        (1.0 - w1)[..., None] * (b0i[..., None] == bins)
        + w1[..., None] * (b1i[..., None] == bins)
    )  # [N, 32, 32, 9]

    wts = jnp.asarray(_spatial_weights())  # [16,16,2,2]
    block_hists = []
    # cv2 descriptor layout is COLUMN-major at both levels: blocks scan
    # x-outer (hog.cpp HOGCache::getBlock indexing) and cells within a
    # block likewise — pinned by the cv2_hog_golden.npz oracle (values
    # matched exactly under this permutation, elementwise 87% off in
    # row-major).
    for bx in range(_NBLOCKS):
        for by in range(_NBLOCKS):
            blk = votes[
                ..., by * _STRIDE : by * _STRIDE + _BLK,
                bx * _STRIDE : bx * _STRIDE + _BLK, :,
            ]  # [N,16,16,9]
            h = jnp.einsum("nijb,ijyx->nxyb", blk, wts,
                           precision=jax.lax.Precision.HIGHEST)  # [N,cx,cy,9]
            block_hists.append(h.reshape(h.shape[0], -1))  # [N,36]

    blocks = jnp.stack(block_hists, axis=1)  # [N, 9, 36]

    # L2-Hys with OpenCV's exact epsilons.
    sz = blocks.shape[-1]
    s1 = jnp.sqrt(jnp.sum(blocks * blocks, axis=-1, keepdims=True))
    blocks = jnp.minimum(blocks / (s1 + sz * 0.1), 0.2)
    s2 = jnp.sqrt(jnp.sum(blocks * blocks, axis=-1, keepdims=True))
    blocks = blocks / (s2 + 1e-3)
    return blocks.reshape(blocks.shape[0], -1)


def gray_descriptors(crops: jnp.ndarray) -> jnp.ndarray:
    """The 'GRAY' feature: raw flattened pixels [N, 1024] float32."""
    return crops.reshape(crops.shape[0], -1).astype(jnp.float32)
