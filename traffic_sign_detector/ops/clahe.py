"""CLAHE (Contrast-Limited Adaptive Histogram Equalization) on device.

Reproduces cv2.createCLAHE(clipLimit=2).apply(gray) — 8x8 tile grid, 256-bin
clipped histograms with OpenCV's excess-redistribution rule, per-tile LUTs
(cumsum scaled by 255/tileArea, round-half-even), and bilinear interpolation
between the four surrounding tile LUTs per pixel.  Replaces
`Deteción de Objetos/source.py:141-142`.

The kernel is expressed as XLA ops (scatter-add histogram + vector math +
gathers); everything is batched over leading dims and jit-friendly.  Images
whose size is not divisible by the tile grid are reflect-101 padded up (the
same border rule OpenCV applies), histograms computed on the padded image,
and output cropped back.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _tile_histograms(gray: jnp.ndarray, tiles: int) -> jnp.ndarray:
    """[B, H, W] uint8 -> [B, tiles, tiles, 256] int32 tile histograms.

    Computed as a fused compare+reduce over the 256 bins instead of a
    scatter-add: the equality-vs-bins reduction is elementwise and fuses
    with the reshape.
    """
    b, h, w = gray.shape
    th, tw = h // tiles, w // tiles
    x = gray.reshape(b, tiles, th, tiles, tw).transpose(0, 1, 3, 2, 4)
    x = x.reshape(b, tiles * tiles, th * tw)
    bins = jnp.arange(256, dtype=jnp.uint8)
    hist = jnp.sum(
        (x[..., None] == bins).astype(jnp.int32), axis=2, dtype=jnp.int32
    )
    return hist.reshape(b, tiles, tiles, 256)


def _clip_and_redistribute(hist: jnp.ndarray, clip_limit: int) -> jnp.ndarray:
    """OpenCV clip rule: cap bins, spread excess evenly, then the residual
    one-per-bin at stride max(256 // residual, 1)."""
    excess = jnp.sum(jnp.maximum(hist - clip_limit, 0), axis=-1, keepdims=True)
    clipped = jnp.minimum(hist, clip_limit)
    batch = excess // 256
    residual = excess - batch * 256  # in [0, 256)
    step = jnp.maximum(256 // jnp.maximum(residual, 1), 1)
    bins = jnp.arange(256, dtype=jnp.int32)
    bonus = (
        (residual > 0)
        & (bins % step == 0)
        & (bins // step < residual)
    ).astype(jnp.int32)
    return clipped + batch + bonus


def _tile_luts(hist: jnp.ndarray, tile_area: int) -> jnp.ndarray:
    """Per-tile LUT: round-half-even(cumsum * 255 / tileArea), uint8."""
    cdf = jnp.cumsum(hist, axis=-1).astype(jnp.float32)
    scale = jnp.float32(255.0 / tile_area)
    return jnp.clip(jnp.rint(cdf * scale), 0, 255).astype(jnp.uint8)


def _interp_coords(size: int, tiles: int, tile_size: int):
    """Static per-pixel tile indices and bilinear weight along one axis."""
    pos = (np.arange(size, dtype=np.float64) / tile_size) - 0.5
    t1 = np.floor(pos).astype(np.int64)
    frac = (pos - t1).astype(np.float32)
    t2 = np.clip(t1 + 1, 0, tiles - 1)
    t1 = np.clip(t1, 0, tiles - 1)
    return t1, t2, frac


def clahe_equalize(
    gray: jnp.ndarray, clip_limit: float = 2.0, tiles: int = 8
) -> jnp.ndarray:
    """CLAHE over uint8 [..., H, W]; returns uint8 of the same shape."""
    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    x = gray.reshape((-1, h, w))

    pad_h = (-h) % tiles
    pad_w = (-w) % tiles
    if pad_h or pad_w:
        x = jnp.pad(x, [(0, 0), (0, pad_h), (0, pad_w)], mode="reflect")
    hp, wp = h + pad_h, w + pad_w

    th, tw = hp // tiles, wp // tiles
    tile_area = th * tw

    clip = max(int(clip_limit * tile_area / 256.0), 1)
    hist = _tile_histograms(x, tiles)
    hist = _clip_and_redistribute(hist, clip)
    luts = _tile_luts(hist, tile_area)  # [B, tiles, tiles, 256]

    ty1, ty2, ya = _interp_coords(hp, tiles, th)
    tx1, tx2, xa = _interp_coords(wp, tiles, tw)

    b_idx = jnp.arange(x.shape[0])[:, None, None]
    ty1 = jnp.asarray(ty1)[None, :, None]
    ty2 = jnp.asarray(ty2)[None, :, None]
    tx1 = jnp.asarray(tx1)[None, None, :]
    tx2 = jnp.asarray(tx2)[None, None, :]
    v = x.astype(jnp.int32)

    p11 = luts[b_idx, ty1, tx1, v].astype(jnp.float32)
    p12 = luts[b_idx, ty1, tx2, v].astype(jnp.float32)
    p21 = luts[b_idx, ty2, tx1, v].astype(jnp.float32)
    p22 = luts[b_idx, ty2, tx2, v].astype(jnp.float32)

    xa = jnp.asarray(xa)[None, None, :]
    ya = jnp.asarray(ya)[None, :, None]
    top = p11 * (1.0 - xa) + p12 * xa
    bot = p21 * (1.0 - xa) + p22 * xa
    out = jnp.rint(top * (1.0 - ya) + bot * ya)
    out = jnp.clip(out, 0, 255).astype(jnp.uint8)

    if pad_h or pad_w:
        out = out[:, :h, :w]
    return out.reshape(lead + (h, w))
