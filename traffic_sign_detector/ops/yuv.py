"""Device-side JPEG 4:2:0 -> BGR: libjpeg's fancy upsample + fixed-point
YCbCr->RGB, bit-for-bit.

The input-feed path (runtime/loader.py: decode_jpeg_yuv420*) ships raw
Y/Cb/Cr planes across the host->device link — 1.5 bytes/px instead of
BGR's 3 — and this module finishes the decode on the accelerator.  Both
halves of libjpeg's back end are reproduced exactly in integer math so a
4:2:0 JPEG decoded via (raw planes -> yuv420_to_bgr) is byte-identical to
libjpeg's own full BGR decode of the same file (asserted in
tests/test_runtime_loader.py):

* ``h2v2 fancy upsampling`` (jdsample.c): the triangle filter.  For
  output row 2r the vertical pair is (3*row[r] + row[r-1]) (clamped at
  the edges), for 2r+1 it is (3*row[r] + row[r+1]); horizontally, even
  output columns take (3*this + left + 8) >> 4 and odd columns
  (3*this + right + 7) >> 4 — the asymmetric rounding is load-bearing
  for bit-exactness.
* ``ycc_rgb_convert`` (jdcolor.c): SCALEBITS=16 fixed point,
  R = y + (FIX(1.40200)(cr-128) + 2^15 >> 16), B likewise with
  FIX(1.77200)(cb-128), G = y + ((-FIX(0.34414))(cb-128) + 2^15
  + (-FIX(0.71414))(cr-128) >> 16), clamped to [0, 255].

The reference decodes with ``cv2.imread`` (full BGR on the CPU —
DET/source.py:101, REC/source.py:243); this path exists because the
host->device link, not decode, bounds end-to-end throughput (PARITY.md
round-4 input-feed note).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# jdcolor.c build_ycc_rgb_table constants: FIX(x) = round(x * 2^16).
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802
_ONE_HALF = 1 << 15


def _fancy_upsample_plane(c: jnp.ndarray) -> jnp.ndarray:
    """libjpeg h2v2_fancy_upsample for one [..., ch, cw] chroma plane
    -> [..., 2*ch, 2*cw] int32 (values still in 0..255)."""
    c = c.astype(jnp.int32)
    up = jnp.concatenate([c[..., :1, :], c[..., :-1, :]], axis=-2)
    down = jnp.concatenate([c[..., 1:, :], c[..., -1:, :]], axis=-2)
    even_rows = 3 * c + up  # output rows 2r
    odd_rows = 3 * c + down  # output rows 2r+1
    # interleave along the row axis: [..., 2*ch, cw]
    v = jnp.stack([even_rows, odd_rows], axis=-2)
    v = v.reshape(*v.shape[:-3], -1, v.shape[-1])
    left = jnp.concatenate([v[..., :, :1], v[..., :, :-1]], axis=-1)
    right = jnp.concatenate([v[..., :, 1:], v[..., :, -1:]], axis=-1)
    even_cols = (3 * v + left + 8) >> 4
    odd_cols = (3 * v + right + 7) >> 4
    out = jnp.stack([even_cols, odd_cols], axis=-1)
    return out.reshape(*out.shape[:-3], out.shape[-3], -1)


@functools.cache
def _fancy_kernel_and_bias() -> tuple:
    """[3, 3, 16, 64] conv kernel + [64] bias for h2v2 fancy upsample on
    the patch grid, and only ONE nonlinearity remains: >> 4 at the end.

    libjpeg's two passes are (vertical, no rounding) then (horizontal,
    (3v + other + 8|7) >> 4), so the whole upsample is
    floor((K * c + bias) / 16) with integer tap products {9, 3, 3, 1} —
    exactly representable in f32 (sums <= 4095), i.e. one conv — exact
    only at full f32 precision (``Precision.HIGHEST``; TF32 would round).
    It replaces a stacked/shifted elementwise formulation whose every op
    lived on 16-wide minor dims."""
    k = np.zeros((3, 3, 16, 64), np.float32)
    bias = np.zeros(64, np.float32)
    for ky in range(8):
        r = ky // 2
        vtaps = [(r, 3.0), (r - 1 if ky % 2 == 0 else r + 1, 1.0)]
        for kx in range(8):
            cc = kx // 2
            htaps = [(cc, 3.0), (cc - 1 if kx % 2 == 0 else cc + 1, 1.0)]
            bias[ky * 8 + kx] = 8.0 if kx % 2 == 0 else 7.0
            for ry, wy in vtaps:
                dy, cy = divmod(ry + 4, 4)      # patch offset in {0,1,2}
                for cx_, wx in htaps:
                    dx, cx = divmod(cx_ + 4, 4)
                    k[dy, dx, cy * 4 + cx, ky * 8 + kx] += wy * wx
    return k, bias


def _pad_chroma_patches(c_p: jnp.ndarray) -> jnp.ndarray:
    """[B, P, Q, 16] -> [B, P+2, Q+2, 16] halo with libjpeg's CLAMP
    semantics: the conv only ever reads row 3 of the top halo patch,
    row 0 of the bottom one, col 3 of the left, col 0 of the right — each
    is set to the frame's replicated edge row/col; everything else is 0
    (never read)."""
    b, p, q, _ = c_p.shape
    z12 = jnp.zeros((b, 1, q, 12), c_p.dtype)
    top = jnp.concatenate([z12, c_p[:, :1, :, 0:4]], axis=-1)
    bot = jnp.concatenate([c_p[:, -1:, :, 12:16], z12], axis=-1)
    cv = jnp.concatenate([top, c_p, bot], axis=1)       # [B, P+2, Q, 16]
    c4 = cv.reshape(b, p + 2, q, 4, 4)
    z3 = jnp.zeros((b, p + 2, 1, 4, 3), c_p.dtype)
    left = jnp.concatenate([z3, c4[:, :, :1, :, 0:1]], axis=-1)
    right = jnp.concatenate([c4[:, :, -1:, :, 3:4], z3], axis=-1)
    ch = jnp.concatenate([left, c4, right], axis=2)
    return ch.reshape(b, p + 2, q + 2, 16)


def _fancy_upsample_patches(c_p: jnp.ndarray) -> jnp.ndarray:
    """Patchified chroma [B, P, Q, 16] (k = cy*4 + cx) -> upsampled
    luma-grid patches [B, P, Q, 64] (k = ky*8 + kx), int32 in 0..255 —
    bit-identical to ``_fancy_upsample_plane`` on the same data, computed
    as ONE 3x3 conv over the patch grid (see _fancy_kernel_and_bias)."""
    from jax import lax

    k, bias = _fancy_kernel_and_bias()
    cp = _pad_chroma_patches(c_p).astype(jnp.float32)
    kj = jnp.asarray(k)
    dn = lax.conv_dimension_numbers(cp.shape, kj.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    acc = lax.conv_general_dilated(cp, kj, (1, 1), "VALID",
                                   dimension_numbers=dn,
                                   precision=lax.Precision.HIGHEST)
    # exact: integer values <= 4095 in f32; /16 is a power-of-two scale
    return jnp.floor((acc + jnp.asarray(bias)) * (1.0 / 16.0)).astype(
        jnp.int32)


def yuv420_patches_to_bgr_patches8(
    y_p: jnp.ndarray, cb_p: jnp.ndarray, cr_p: jnp.ndarray
) -> jnp.ndarray:
    """Patchified raw 4:2:0 planes -> BGR in the ``patches8`` stem layout.

    ``y_p`` [B, H/8, W/8, 64] (k = ky*8 + kx), ``cb_p``/``cr_p``
    [B, H/8, W/8, 16] (k = cy*4 + cx) — the layouts the native loader
    emits for free at decode time (runtime/loader.cpp:
    tsd_decode_jpeg_yuv420_patches_batch; host repack fallback
    ``patchify_yuv_planes``).  Output [B, H/8, W/8, 192] uint8 with
    k = ky*24 + kx*3 + c, bit-identical to
    ``yuv420_to_bgr`` followed by an 8x8 patchify
    (tests/test_runtime_loader.py) — but with zero on-device relayout:
    the channel interleave at the end is a free minor-dim reshape, so the
    half-bandwidth ingest feeds the stem like patches8 does, with no
    in-graph patchify."""
    cb_full = _fancy_upsample_patches(cb_p)
    cr_full = _fancy_upsample_patches(cr_p)
    yi = y_p.astype(jnp.int32)
    cbd = cb_full - 128
    crd = cr_full - 128
    r = yi + ((_FIX_1_40200 * crd + _ONE_HALF) >> 16)
    g = yi + ((-_FIX_0_34414 * cbd + _ONE_HALF - _FIX_0_71414 * crd) >> 16)
    b = yi + ((_FIX_1_77200 * cbd + _ONE_HALF) >> 16)
    bgr = jnp.clip(jnp.stack([b, g, r], axis=-1), 0, 255)  # [.., 64, 3]
    return bgr.astype(jnp.uint8).reshape(*y_p.shape[:-1], 192)


def patchify_yuv_planes(y, cb, cr):
    """Host-side (numpy) repack of tight 4:2:0 planes into the patchified
    layouts ``yuv420_patches_to_bgr_patches8`` consumes — the fallback for
    JPEG batches the native loader cannot decode directly, and the oracle
    for its C++ repack.  Requires h, w multiples of 8."""
    import numpy as np

    b, h, w = y.shape
    yp = (y.reshape(b, h // 8, 8, w // 8, 8)
          .transpose(0, 1, 3, 2, 4).reshape(b, h // 8, w // 8, 64))
    ch, cw = cb.shape[1:]
    cbp = (cb.reshape(b, ch // 4, 4, cw // 4, 4)
           .transpose(0, 1, 3, 2, 4).reshape(b, ch // 4, cw // 4, 16))
    crp = (cr.reshape(b, ch // 4, 4, cw // 4, 4)
           .transpose(0, 1, 3, 2, 4).reshape(b, ch // 4, cw // 4, 16))
    return (np.ascontiguousarray(yp), np.ascontiguousarray(cbp),
            np.ascontiguousarray(crp))


def yuv420_to_bgr(
    y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray
) -> jnp.ndarray:
    """[..., h, w] luma + [..., ceil(h/2), ceil(w/2)] chroma -> BGR uint8
    [..., h, w, 3], byte-identical to libjpeg's BGR decode of the same
    4:2:0 stream.  Jittable; batch dims broadcast through."""
    h, w = y.shape[-2], y.shape[-1]
    cb_full = _fancy_upsample_plane(cb)[..., :h, :w]
    cr_full = _fancy_upsample_plane(cr)[..., :h, :w]
    yi = y.astype(jnp.int32)
    cbd = cb_full - 128
    crd = cr_full - 128
    r = yi + ((_FIX_1_40200 * crd + _ONE_HALF) >> 16)
    g = yi + ((-_FIX_0_34414 * cbd + _ONE_HALF - _FIX_0_71414 * crd) >> 16)
    b = yi + ((_FIX_1_77200 * cbd + _ONE_HALF) >> 16)
    bgr = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(bgr, 0, 255).astype(jnp.uint8)
