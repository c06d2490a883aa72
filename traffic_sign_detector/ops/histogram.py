"""Hue/Saturation 2-D histograms + Pearson correlation, batched on device.

The reference compares detection crops pairwise with cv2.calcHist (50x60 H/S
bins), cv2.normalize(MINMAX to [0,1]) and cv2.compareHist(HISTCMP_CORREL)
(`Deteción de Objetos/source.py:575-586,200-202`).  Here the histograms of
all crops are computed at once (scatter-add over a [N, 3000] table) and the
full pairwise correlation matrix is one centered matmul — the O(n^2) Python
loop becomes one matrix contraction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .color import bgr_to_hsv

# parity-path float products: full f32, never TF32 (exactness vs the
# float64 reference / CPU backend is what these stages are checked on)
_HI = jax.lax.Precision.HIGHEST

H_BINS = 50
S_BINS = 60


def hs_histograms(crops_bgr: jnp.ndarray) -> jnp.ndarray:
    """[N, H, W, 3] BGR uint8 -> [N, H_BINS*S_BINS] float32 raw counts.

    The 2-D histogram is separable over its axes: per pixel it adds the
    outer product of the one-hot H-bin and one-hot S-bin vectors, so the
    whole table is one batched einsum over the per-pixel one-hots — a
    contraction instead of a [N, 3000]-table scatter-add.
    """
    hsv = bgr_to_hsv(crops_bgr)
    n = crops_bgr.shape[0]
    h = hsv[..., 0].astype(jnp.int32)
    s = hsv[..., 1].astype(jnp.int32)
    hb = jnp.clip((h * H_BINS) // 180, 0, H_BINS - 1).reshape(n, -1)
    sb = jnp.clip((s * S_BINS) // 256, 0, S_BINS - 1).reshape(n, -1)
    oh_h = (hb[:, :, None] == jnp.arange(H_BINS)[None, None, :]).astype(
        jnp.float32
    )
    oh_s = (sb[:, :, None] == jnp.arange(S_BINS)[None, None, :]).astype(
        jnp.float32
    )
    hist = jnp.einsum("nph,nps->nhs", oh_h, oh_s, precision=_HI)
    return hist.reshape(n, H_BINS * S_BINS)


def minmax_normalize(hist: jnp.ndarray) -> jnp.ndarray:
    """Per-row NORM_MINMAX to [0, 1]; constant rows map to 0 (cv2 rule)."""
    mn = jnp.min(hist, axis=-1, keepdims=True)
    mx = jnp.max(hist, axis=-1, keepdims=True)
    rng = mx - mn
    scale = jnp.where(rng > 0, 1.0 / jnp.maximum(rng, 1e-30), 0.0)
    return (hist - mn) * scale


def correlation_matrix(a: jnp.ndarray, b: jnp.ndarray | None = None) -> jnp.ndarray:
    """Pairwise HISTCMP_CORREL: Pearson correlation over bins.

    a: [N, D], b: [M, D] (defaults to a) -> [N, M].  Degenerate rows (zero
    variance) correlate to 1.0 with anything, matching OpenCV's convention of
    returning 1 when the denominator vanishes.
    """
    if b is None:
        b = a
    ac = a - jnp.mean(a, axis=-1, keepdims=True)
    bc = b - jnp.mean(b, axis=-1, keepdims=True)
    num = jnp.matmul(ac, bc.T, precision=_HI)
    va = jnp.sum(ac * ac, axis=-1)
    vb = jnp.sum(bc * bc, axis=-1)
    den = jnp.sqrt(va[:, None] * vb[None, :])
    return jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-30), 1.0)


def hist_correlation(crops_bgr: jnp.ndarray) -> jnp.ndarray:
    """All-pairs appearance similarity of a crop stack: [N, N] float32."""
    h = minmax_normalize(hs_histograms(crops_bgr))
    return correlation_matrix(h)
