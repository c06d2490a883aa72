"""Whole-frame bilinear upscale as phase-sliced 2-tap passes.

The upscaled-inference product mode (``--upscale``, models/cnn_detector.py)
originally rode ``jax.image.resize``: XLA lowers that to DENSE [out, in]
weight matmuls per axis — ~3.2 TFLOP of f32 work per 128-frame batch for
1360x800 -> 1920x1136.  A bilinear upscale has only TWO taps per output
pixel, so 99.75% of those FLOPs multiply zeros.

This module exploits the rational-scale structure instead.  With
``g = gcd(in, out)`` the source phase pattern repeats every ``T = out/g``
output pixels (covering ``A = in/g`` input pixels), so the axis splits
into g identical blocks and the whole pass is ONE [T, A] banded matmul
against a reshape view of the input (~60+30 GFLOP per batch at the
1.412x point, 34x less than dense), with the two cross-block tap columns
folded in as rank-1 broadcast adds.  The product scales keep the band
tiny: 1360x800 -> 1920x1136 gives [24, 17] cols / [71, 50] rows.
Degenerate ratios (T > ``_MAX_PHASES``) fall back to the dense
``jax.image.resize`` formulation.

Semantics match ``jax.image.resize(..., "bilinear")`` for upscaling:
half-pixel sample centers ``(i + 0.5) * in/out - 0.5``, triangle kernel,
edge taps renormalized — which for a 2-tap kernel is exactly replicate
padding (the out-of-range tap collapses onto the edge pixel with total
weight 1).  Weights here are computed in f64 and baked as f32 scalar
constants, so outputs can differ from jax.image.resize by float rounding
only — bounded at ±1 u8 count after the round (tests/test_upscale.py),
and measured quality-neutral on the 150-frame protocol (PARITY.md).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

# Above this many phases per axis the stack/slice unrolling stops paying
# for itself (compile time, concat pressure); fall back to the dense path.
# Every shipped operating point (1.412x, 1.7x, 2x, the 1080p protocol) is
# far below it.
_MAX_PHASES = 192


def _phase_plan(in_size: int, out_size: int):
    """Per-phase (padded start index j, w0, w1) for a 2-tap upscale axis.

    Returns ``(A, g, T, taps)`` with ``taps[p] = (j, w0, w1)`` where ``j``
    indexes into the 1-replicate-padded axis, or ``None`` when the phase
    count T exceeds _MAX_PHASES.
    """
    g = math.gcd(in_size, out_size)
    T = out_size // g
    A = in_size // g
    if T > _MAX_PHASES:
        return None
    taps = []
    for p in range(T):
        x = (p + 0.5) * in_size / out_size - 0.5
        i0 = math.floor(x)
        f = x - i0
        # j indexes the replicate-padded axis (offset +1); the padding
        # reproduces jax.image.resize's edge renormalization exactly for
        # a 2-tap kernel (w0*edge + w1*edge == edge).
        taps.append((i0 + 1, 1.0 - f, f))
    return A, g, T, taps


def _band_matrix(A: int, T: int, taps) -> "np.ndarray":
    """[T, A+2] bilinear band: W[p, j] over padded in-block offsets."""
    import numpy as np

    W = np.zeros((T, A + 2), np.float32)
    for p, (j, w0, w1) in enumerate(taps):
        W[p, j] += np.float32(w0)
        W[p, j + 1] += np.float32(w1)
    return W


def _upscale_axis(x: jax.Array, axis: int, out_size: int) -> jax.Array:
    """One separable bilinear pass along ``axis`` (blocked-banded matmul).

    The padded axis splits into ``g`` blocks of ``A`` source pixels; every
    block produces the same ``T`` output phases, so the whole pass is ONE
    small dot against the [T, A] in-block band (the first strided-slice
    formulation was slower than the dense resize — 71 stride-50 slices;
    the blocked dot reads straight from a reshape view instead).  A
    phase's second tap can fall on the next
    block's first rows (padded offsets A, A+1); those two columns are
    rank-1 terms added as broadcast fused into the dot's epilogue.
    """
    in_size = x.shape[axis]
    plan = _phase_plan(in_size, out_size)
    if plan is None:
        # explicit error (asserts vanish under python -O) —
        # callers gate on _phase_plan and route degenerate axes to
        # _dense_axis, so reaching this means a direct mis-call.
        raise ValueError(
            f"no phase plan for axis {axis}: {in_size} -> {out_size} "
            f"(phase count exceeds _MAX_PHASES={_MAX_PHASES}); use the "
            "dense resize path")
    A, g, T, taps = plan
    W = _band_matrix(A, T, taps)

    edge_lo = lax.slice_in_dim(x, 0, 1, axis=axis)
    edge_hi = lax.slice_in_dim(x, in_size - 1, in_size, axis=axis)
    xp = jnp.concatenate([edge_lo, x, edge_hi], axis=axis)
    # padded tap index for block k, phase p: k*A + j(p), j in [0, A+1]
    main = lax.slice_in_dim(xp, 0, in_size, axis=axis)
    nxt0 = lax.slice_in_dim(xp, A, A + A * (g - 1) + 1, stride=A, axis=axis)
    nxt1 = lax.slice_in_dim(xp, A + 1, A + 1 + A * (g - 1) + 1, stride=A,
                            axis=axis)

    Wm = jnp.asarray(W[:, :A])
    w_n0 = jnp.asarray(W[:, A])     # [T]
    w_n1 = jnp.asarray(W[:, A + 1])
    if axis == 1:
        b, _, w, c = x.shape
        main = main.reshape(b, g, A, w, c)
        out = jnp.einsum("pa,bgawc->bgpwc", Wm, main,
                         preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)
        out = out + w_n0[None, None, :, None, None] * nxt0[:, :, None]
        out = out + w_n1[None, None, :, None, None] * nxt1[:, :, None]
        return out.reshape(b, out_size, w, c)
    b, h, _, c = x.shape
    main = main.reshape(b, h, g, A, c)
    out = jnp.einsum("pa,bhgac->bhgpc", Wm, main,
                     preferred_element_type=jnp.float32,
                     precision=lax.Precision.HIGHEST)
    out = out + w_n0[None, None, None, :, None] * nxt0[:, :, :, None]
    out = out + w_n1[None, None, None, :, None] * nxt1[:, :, :, None]
    return out.reshape(b, h, out_size, c)


def _dense_axis(x: jax.Array, axis: int, out_size: int) -> jax.Array:
    """Single-axis dense bilinear resize (fallback for degenerate ratios)."""
    shape = list(x.shape)
    shape[axis] = out_size
    return jax.image.resize(x.astype(jnp.float32), tuple(shape), "bilinear")


def upscale_bilinear_u8(frames_u8: jax.Array, th: int, tw: int) -> jax.Array:
    """Bilinear resize of [B, H, W, C] uint8 frames to (th, tw), uint8 out.

    Float32 interpolation, round, clip — the exact formulation the measured
    upscaled-inference quality numbers used (models/cnn_detector.py:
    upscale_frames), but phase-sliced so the hot path costs bandwidth, not
    dense-matmul FLOPs.  Downscaling axes ride the dense ``jax.image.resize`` path,
    and each axis is gated independently so one degenerate
    ratio no longer forfeits the phase-sliced saving on the other axis.
    """
    b, h, w, c = frames_u8.shape
    x = frames_u8
    # u8 feeds the first phase-sliced pass directly (the convert fuses into
    # the dot); the inter-pass intermediate is f32
    if th != h:
        if th < h or _phase_plan(h, th) is None:
            x = _dense_axis(x, 1, th)
        else:
            x = _upscale_axis(x, 1, th)
    if tw != w:
        if tw < w or _phase_plan(w, tw) is None:
            x = _dense_axis(x, 2, tw)
        else:
            x = _upscale_axis(x, 2, tw)
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)
