"""Color-space ops with OpenCV-exact uint8 fixed-point semantics.

All functions operate on channel-last arrays with arbitrary leading batch
dims and are jit/vmap friendly (static shapes, integer math).  They replace
the reference's cv2.cvtColor / cv2.inRange / cv2.LUT calls
(`Deteción de Objetos/source.py:63-89,137,599-605`).

OpenCV 8-bit conversions are fixed-point with specific rounding; we reproduce
them bit-exactly (verified against cv2 in tests):

* BGR->GRAY: ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15`` (validated exact
  against cv2 over the full 256^3 truth table)
* BGR->HSV: V = max; S via the 12-bit reciprocal table; H via the 12-bit
  ``180/(6*diff)`` table with the V-channel priority R, then G, then B.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_HSV_SHIFT = 12


@functools.cache
def _sdiv_table() -> np.ndarray:
    v = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint((255 << _HSV_SHIFT) / v)
    t[0] = 0
    return t.astype(np.int32)


@functools.cache
def _hdiv_table() -> np.ndarray:
    d = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint((180 << _HSV_SHIFT) / (6.0 * d))
    t[0] = 0
    return t.astype(np.int32)


def bgr_to_gray(bgr: jnp.ndarray) -> jnp.ndarray:
    """BGR uint8 [..., 3] -> gray uint8 [...] (OpenCV fixed-point weights).

    Channels are sliced from a [..., W*3] view rather than the [..., 3]
    axis: a 3-wide trailing dimension makes a poor minor dimension for
    vector code.
    """
    flat = bgr.reshape(*bgr.shape[:-2], bgr.shape[-2] * 3).astype(jnp.int32)
    b = flat[..., 0::3]
    g = flat[..., 1::3]
    r = flat[..., 2::3]
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.astype(jnp.uint8)


def bgr_to_hsv(bgr: jnp.ndarray) -> jnp.ndarray:
    """BGR uint8 [..., 3] -> HSV uint8 [..., 3], H in [0, 179]."""
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)

    v = jnp.maximum(jnp.maximum(b, g), r)
    mn = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - mn

    # The OpenCV fixed-point tables are sdiv[x] = rint((255<<12)/x) and
    # hdiv[x] = rint((180<<12)/(6x)); computed inline as f32 divisions
    # instead of per-pixel gathers.  Bit-exact: the quotients are
    # rationals k/x whose distance from any half-integer is >= 1/(2x),
    # while the f32 division error is <= (C/x)*2^-24 < 0.0625/x — rint
    # can never tip the wrong way (asserted exhaustively in
    # tests/test_ops_color.py::test_hsv_div_arithmetic_matches_tables).
    vf = v.astype(jnp.float32)
    df = diff.astype(jnp.float32)
    sdiv_v = jnp.where(
        v > 0, jnp.rint(float(255 << _HSV_SHIFT) / jnp.maximum(vf, 1.0)), 0.0
    ).astype(jnp.int32)
    hdiv_d = jnp.where(
        diff > 0,
        jnp.rint((float(180 << _HSV_SHIFT) / 6.0) / jnp.maximum(df, 1.0)),
        0.0,
    ).astype(jnp.int32)
    s = (diff * sdiv_v + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT

    # Hue numerator: priority order V==R, then V==G, then V==B (OpenCV).
    is_r = v == r
    is_g = jnp.logical_and(v == g, ~is_r)
    numer = jnp.where(
        is_r, g - b, jnp.where(is_g, b - r + 2 * diff, r - g + 4 * diff)
    )
    h = (numer * hdiv_d + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = jnp.where(h < 0, h + 180, h)

    return jnp.stack(
        [h.astype(jnp.uint8), s.astype(jnp.uint8), v.astype(jnp.uint8)], axis=-1
    )


def _in_range(hsv: jnp.ndarray, lo: tuple, hi: tuple) -> jnp.ndarray:
    ok = jnp.ones(hsv.shape[:-1], dtype=bool)
    for c in range(3):
        x = hsv[..., c]
        ok &= (x >= lo[c]) & (x <= hi[c])
    return ok


def color_mask(bgr: jnp.ndarray, color: str) -> jnp.ndarray:
    """Red/blue HSV threshold mask -> uint8 {0, 255} [...].

    Red is the union of the two hue bands around 0/180; blue a single band.
    Thresholds from :mod:`..constants` (reference source.py:63-89).
    """
    from ..constants import BLUE_BAND, RED_HIGH_BAND, RED_LOW_BAND

    hsv = bgr_to_hsv(bgr)
    if color == "r":
        m = _in_range(hsv, *RED_LOW_BAND) | _in_range(hsv, *RED_HIGH_BAND)
    elif color == "b":
        m = _in_range(hsv, *BLUE_BAND)
    else:
        raise ValueError(f"color must be 'r' or 'b', got {color!r}")
    return (m.astype(jnp.uint8)) * jnp.uint8(255)


@functools.cache
def gamma_lut(gamma: float) -> np.ndarray:
    """256-entry uint8 gamma table, reproducing the reference's truncation
    (`np.array([...], np.uint8)` truncates toward zero, source.py:599-605)."""
    i = np.arange(256, dtype=np.float64)
    table = ((i / 255.0) ** (1.0 / gamma)) * 255.0
    return table.astype(np.uint8)


@functools.cache
def _gamma_thresholds(gamma: float) -> np.ndarray:
    """Jump inputs of the (monotone) gamma LUT: t[b] = min{i : lut[i] >= b}.

    The LUT apply then becomes the gather-free count
    ``out = sum_b (x >= t[b])`` — exact for any monotone table.  Entries
    with no preimage get threshold 256 (never contributes).
    """
    lut = gamma_lut(gamma).astype(np.int32)
    t = np.full(256, 256, np.int32)
    for i in range(255, -1, -1):
        t[lut[i]] = i
    # fill gaps: t[b] = t of the next value that does occur
    for b in range(254, 0, -1):
        if t[b] == 256:
            t[b] = t[b + 1]
    return t[1:]  # b = 0 always contributes nothing


def gamma_correct(img: jnp.ndarray, gamma: float = 2.0) -> jnp.ndarray:
    """Apply the uint8 gamma LUT elementwise (cv2.LUT equivalent).

    Gather-free: instead of a per-pixel 256-entry LUT gather, the
    monotone-LUT threshold count is pure elementwise compares that XLA
    fuses into one pass (bit-exact vs the table by construction, asserted
    in tests/test_ops_color.py).

    For the shipped gamma=2 the table is ``lut[i] = trunc(255*(i/255)^0.5)
    = floor(sqrt(255*i))``, which one f32 sqrt evaluates exactly: IEEE
    sqrt is correctly rounded, and the nearest integer boundary is >= 1
    away from ``255*i`` unless ``255*i`` is itself a perfect square
    (i = 0, 255 — both exact), so the floor can never flip.  One
    elementwise op per pixel instead of 255 compares; bit-exactness vs the
    table is asserted in tests.
    """
    if float(gamma) == 2.0:
        y = jnp.sqrt(img.astype(jnp.float32) * 255.0)
        return y.astype(jnp.uint8)  # f32->u8 cast truncates (floor, x >= 0)
    t = jnp.asarray(_gamma_thresholds(float(gamma)))  # [255]
    x = img.astype(jnp.int16)[..., None]
    out = jnp.sum(
        (x >= t.astype(jnp.int16)).astype(jnp.uint8), axis=-1, dtype=jnp.int32
    )
    return out.astype(jnp.uint8)
