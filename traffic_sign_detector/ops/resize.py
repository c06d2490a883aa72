"""Batched dynamic crop + bilinear resize (the cv2.resize replacement).

The reference crops numpy slices then calls cv2.resize per window
(`Deteción de Objetos/source.py:123-124,570-572`).  Here all N proposals of a
frame are cropped and resized in one fixed-shape gather kernel: boxes are
dynamic values, output size is static, so the whole thing jits and vmaps.

Sampling uses OpenCV INTER_LINEAR geometry: src = (dst + 0.5) * scale - 0.5,
coordinates clamped to the (clamped-to-image) crop window, float bilinear
with round-half-even output.  OpenCV's uint8 path quantizes the weights to
1/2048ths, so outputs can differ by ±1 count on a small fraction of pixels;
downstream consumers (histograms, color masks, HOG) are tolerant (verified in
the pipeline parity tests).

Out-of-image growth is handled like numpy slicing in the reference: the crop
is silently intersected with the image before resizing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Window side for the slice+matmul fast path.  Boxes from the detection
# pipeline are bounded by the refinement window (128) times the 1.30 grow
# (~167); anything wider falls back to edge-clamped sampling at the window
# border (cannot occur with the shipped configs).
_CROP_WIN = 192


def _source_coords(boxes_xyxy, h, w, out_size):
    """Per-box OpenCV INTER_LINEAR source coordinates [N, out_size] (y, x)."""
    b = boxes_xyxy.astype(jnp.float32)
    x1 = jnp.clip(b[:, 0], 0.0, w - 1)
    y1 = jnp.clip(b[:, 1], 0.0, h - 1)
    x2 = jnp.clip(b[:, 2], 0.0, w)
    y2 = jnp.clip(b[:, 3], 0.0, h)
    cw = jnp.maximum(x2 - x1, 1.0)
    ch = jnp.maximum(y2 - y1, 1.0)

    s = jnp.arange(out_size, dtype=jnp.float32) + 0.5
    sx = x1[:, None] + s[None, :] * (cw[:, None] / out_size) - 0.5
    sy = y1[:, None] + s[None, :] * (ch[:, None] / out_size) - 0.5
    sx = jnp.clip(sx, x1[:, None], x1[:, None] + cw[:, None] - 1.0)
    sy = jnp.clip(sy, y1[:, None], y1[:, None] + ch[:, None] - 1.0)
    sx = jnp.clip(sx, 0.0, w - 1.0)
    sy = jnp.clip(sy, 0.0, h - 1.0)
    return sy, sx, y1, x1


def _crop_resize_gather(image, boxes_xyxy, out_size):
    """Reference formulation: 4 bilinear corner gathers per output pixel."""
    h, w = image.shape[0], image.shape[1]
    sy, sx, _, _ = _source_coords(boxes_xyxy, h, w, out_size)

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)

    flat = image.reshape(h * w, -1).astype(jnp.float32)  # [H*W, C]

    def sample(yi, xi):
        idx = yi[:, :, None] * w + xi[:, None, :]
        return jnp.take(flat, idx, axis=0)  # [N, S_y, S_x, C]

    p00 = sample(y0i, x0i)
    p01 = sample(y0i, x1i)
    p10 = sample(y1i, x0i)
    p11 = sample(y1i, x1i)

    fx2 = fx[:, None, :, None]
    fy2 = fy[:, :, None, None]
    top = p00 * (1 - fx2) + p01 * fx2
    bot = p10 * (1 - fx2) + p11 * fx2
    return jnp.rint(top * (1 - fy2) + bot * fy2)


def _crop_resize_window(image, boxes_xyxy, out_size):
    """Fast path: per-box window slice + bilinear-weight matmuls.

    Instead of per-element gathers, a dynamic_slice copies a block and the
    bilinear interpolation over the window is two small matmuls with
    hat-function weight matrices (identical weights to
    the gather formulation; float association differs, so outputs may
    flip by 1 count at exact .5 boundaries — inside the cv2 parity band).
    """
    h, w, c = image.shape
    n = boxes_xyxy.shape[0]
    win = _CROP_WIN
    sy, sx, y1, x1 = _source_coords(boxes_xyxy, h, w, out_size)
    wy0 = jnp.clip(y1.astype(jnp.int32), 0, h - win)
    wx0 = jnp.clip(x1.astype(jnp.int32), 0, w - win)
    rel_y = jnp.clip(sy - wy0[:, None].astype(jnp.float32), 0.0, win - 1.0)
    rel_x = jnp.clip(sx - wx0[:, None].astype(jnp.float32), 0.0, win - 1.0)

    wins = jax.vmap(
        lambda y0, x0: jax.lax.dynamic_slice(image, (y0, x0, 0), (win, win, c))
    )(wy0, wx0).astype(jnp.float32)

    # hat weights: rows [N, S, win], cols [N, S, win]
    grid = jnp.arange(win, dtype=jnp.float32)
    ry = jnp.maximum(0.0, 1.0 - jnp.abs(rel_y[:, :, None] - grid))
    rx = jnp.maximum(0.0, 1.0 - jnp.abs(rel_x[:, :, None] - grid))

    tmp = jnp.einsum(
        "nsh,nhwc->nswc", ry, wins, precision=jax.lax.Precision.HIGHEST
    )
    out = jnp.einsum(
        "ntw,nswc->nstc", rx, tmp, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.rint(out)


def crop_and_resize(
    image: jnp.ndarray,
    boxes_xyxy: jnp.ndarray,
    out_size: int,
    exact: bool = False,
) -> jnp.ndarray:
    """Crop + bilinear-resize each box of one frame.

    image: [H, W] or [H, W, C] uint8
    boxes_xyxy: [N, 4] int32 (x1, y1, x2, y2), half-open like numpy slices
    returns: [N, out_size, out_size(, C)] uint8

    Bound: the default fast path samples each box through a fixed
    192x192 (`_CROP_WIN`) window; a box WIDER OR TALLER than 192 px gets
    its source coordinates edge-clamped, i.e. a distorted crop.  Every
    shipped config stays inside the bound (refine window 128 x grow 1.30
    ~ 167), but callers that may pass larger boxes must set
    ``exact=True`` to route all boxes through the slower per-element
    gather path, which is correct for any box size.
    """
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    h, w = image.shape[0], image.shape[1]

    if not exact and h >= _CROP_WIN and w >= _CROP_WIN:
        out = _crop_resize_window(image, boxes_xyxy, out_size)
    else:
        out = _crop_resize_gather(image, boxes_xyxy, out_size)
    out = jnp.clip(out, 0, 255).astype(jnp.uint8)
    if squeeze:
        out = out[..., 0]
    return out


def resize_batch(images: jnp.ndarray, out_size: int) -> jnp.ndarray:
    """Resize a stack [N, H, W(, C)] to [N, out_size, out_size(, C)]
    (whole-image special case of crop_and_resize)."""
    n = images.shape[0]
    h, w = images.shape[1], images.shape[2]
    boxes = jnp.tile(jnp.array([[0, 0, w, h]], jnp.int32), (n, 1))
    # crop_and_resize expects one image; vmap pairing image_i with box_i
    fn = jax.vmap(lambda im, bx: crop_and_resize(im, bx[None], out_size)[0])
    return fn(images, boxes)
