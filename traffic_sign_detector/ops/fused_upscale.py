"""Upscaled inference without an upscaled frame: upscale∘patchify∘stem
folded into banded matmuls on NATIVE pixels.

Round 4 shipped ``--upscale`` (models/cnn_detector.py) as the quality
flagship — bilinearly scaling frames on device recovers the small-sign
quality the stride-16 grid gives up at native GTSDB resolution (AP 0.852
-> 0.94 at 1.412x) — but it materializes an upscaled frame (2x the pixels
in device memory) and patchifies it in-graph.  Every stage between the
native u8 frame and the first stem activation is LINEAR, so the chain

    frame --bilinear upscale--> U --8x8 patchify--> P --K=192 matmul--> stem

is ONE linear map from native pixels to stem activations.  This module
evaluates that map directly; the upscaled frame never exists.

Structure exploited (all shapes static, every pass a conv XLA tiles
itself — PARITY.md round 5 records the formulations that were rejected):

* **Width**: a rational scale T/A upsamples each block of A input columns
  to T output columns with a fixed 2-tap phase pattern (ops/upscale.py:
  _phase_plan).  The frame reshapes FREELY to [B, h, w/n, 3n] (one
  n-column superblock per position, n = lcm(8,T)*A/T/8... see find_plan),
  and the whole banded pass becomes a **[1, 3] conv over the block grid**
  (each block needs one column from each neighbor).  Output channels are
  ordered (t, kx, c) so the result reshapes freely to [B, h, w_out/8, 24]
  — upscaled columns already split into stem patch columns.
* **Height + stem**: stem row i consumes upscaled rows [8i, 8i+8).  With
  sb = lcm(8, T)/8, the tap pattern of sb consecutive stem rows repeats
  every n native rows, so the height pass and the stem's K=192 matmul
  combine into ONE composite weight ``KH[u, q, sb*F]`` applied as a
  **stride-n conv with an (n+2)-row kernel** — XLA's conv lowering keeps
  the overlapping windows on chip instead of packing them explicitly.
* **Replicate padding is algebraic**: the convs zero-pad (free), and the
  few windows that touch padding get their replicate-edge contribution
  back as tiny outer-product corrections routed through the same linear
  height stage — nothing ever copies the frame or the intermediate.

Shipped operating points on 800x1360 GTSDB frames: ``--upscale 1.6`` ->
plan 8/5 (1280x2176 virtual), the round-5 quality flagship — **F1 0.85 /
AP 0.954 float, 0.85/0.950 int8** with the zoom-1.75-trained checkpoint,
vs AP 0.936 for round 4's materialize-then-forward path.  ``--upscale
1.412`` -> plan 24/17 (1152x1920), within 0.03% of round 4's protocol
scale.  The quality-vs-scale landscape is jagged (±0.03 AP between
nearby ratios — grid-phase jitter over the 150-frame protocol), so
operating points are picked by measured sweep, not interpolation.

Semantics vs the two-stage product path (upscale_bilinear_u8 -> stem):
identical linear map evaluated in a different association; the ONLY
intentional difference is that the u8 round/clip of the intermediate
upscaled frame disappears (the fused path is *more* faithful to the
bilinear math).  tests/test_fused_upscale.py pins exact agreement with an
un-rounded float reference and near-agreement with the shipped two-stage
path on the real checkpoint.

Reference pointer: the reference has no multi-scale inference at all
(detection runs at native frame resolution, ``Deteción de
Objetos/source.py:111-131``); this is a beyond-parity product mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from .upscale import _MAX_PHASES, _upscale_axis

_PATCH = 8
# the composite-weight folds and the edge corrections are f32 products:
# full f32, never TF32 (the convs run in the caller's explicit dtype)
_HI = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class FusedUpscalePlan:
    """Static geometry of one fused upscale+stem configuration.

    Hashable (jit-static).  ``t/a`` is the reduced rational scale used on
    BOTH axes (aspect-preserving); ``h_pad/w_pad`` the replicate-padded
    native dims; ``h_out/w_out`` the virtual upscaled dims (multiples of
    16 so the v3 trunk tiles them); ``sb`` stem rows per height
    superblock; ``n`` native rows per superblock.
    """

    h: int
    w: int
    t: int
    a: int
    h_pad: int
    w_pad: int
    h_out: int
    w_out: int
    sb: int
    n: int

    @property
    def scale(self) -> float:
        return self.t / self.a

    def rescale_factors(self) -> tuple[float, float]:
        """(sx, sy) mapping upscaled-grid boxes back to native pixels."""
        return self.t / self.a, self.t / self.a


def find_plan(h: int, w: int, scale: float, *, a_max: int = 24,
              sb_max: int = 4, pad_max: int = 40,
              tol: float = 0.02) -> FusedUpscalePlan | None:
    """Best fusable rational approximation of ``scale`` for an (h, w) frame.

    Scans denominators a <= a_max for t/a within ``tol`` of the requested
    scale whose height superblock sb = lcm(8, t)/8 stays <= ``sb_max``
    (the einsum contraction grows as sb) and whose alignment padding stays
    <= ``pad_max`` native rows/cols per axis.  Returns None when no such
    ratio exists (callers fall back to the two-stage dense path).
    """
    if scale <= 1.0:
        return None
    best: FusedUpscalePlan | None = None
    best_key = None
    seen: set[tuple[int, int]] = set()
    for a_try in range(1, a_max + 1):
        t_try = round(scale * a_try)
        if t_try <= a_try:
            continue
        frac = Fraction(t_try, a_try)
        t, a = frac.numerator, frac.denominator
        if (t, a) in seen or t > _MAX_PHASES:
            continue
        seen.add((t, a))
        err = abs(t / a - scale)
        if err > tol:
            continue
        sb = math.lcm(8, t) // 8
        if sb > sb_max:
            continue
        n = sb * 8 * a // t  # native rows per superblock (exact by lcm)
        # height: h_out must be a multiple of lcm(sb*8, 16); width: of 16
        l_h = math.lcm(sb * 8, 16)
        m_h = a * l_h // math.gcd(t, l_h)
        m_w = a * 16 // math.gcd(t, 16)
        h_pad = -(-h // m_h) * m_h
        w_pad = -(-w // m_w) * m_w
        if h_pad - h > pad_max or w_pad - w > pad_max:
            continue
        plan = FusedUpscalePlan(h=h, w=w, t=t, a=a, h_pad=h_pad,
                                w_pad=w_pad, h_out=h_pad * t // a,
                                w_out=w_pad * t // a, sb=sb, n=n)
        key = (err, (h_pad - h) + (w_pad - w), sb)
        if best_key is None or key < best_key:
            best, best_key = plan, key
    return best


def _superblock_taps(t: int, a: int, sb: int, n: int) -> np.ndarray:
    """[sb, 8, n+2] f32: weight of padded native offset u for patch phase
    (t', p) — the bilinear 2-tap pattern of ops/upscale.py (half-pixel
    centers, replicate edges) unrolled over one superblock.  Axis-agnostic:
    the same matrix drives the width pass (as upscale weights) and the
    height pass (folded with the stem kernel).

    ``u`` indexes the 1-replicate-padded native axis (offset +1), so
    u = 0 is the previous superblock's last element and u = n, n+1 are
    the next superblock's first two.
    """
    phases = sb * 8
    tap = np.zeros((phases, n + 2), np.float64)
    for phi in range(phases):
        blk, p = divmod(phi, t)
        x = (p + 0.5) * a / t - 0.5
        i0 = math.floor(x)
        f = x - i0
        u = a * blk + i0 + 1
        tap[phi, u] += 1.0 - f
        tap[phi, u + 1] += f
    return tap.reshape(sb, 8, n + 2).astype(np.float32)


def fused_upscale_stem(frames_u8: jax.Array, kernel: jax.Array,
                       bias: jax.Array, plan: FusedUpscalePlan,
                       dtype=jnp.bfloat16) -> jax.Array:
    """Native u8 frames -> v3 stem activations at the upscaled resolution.

    ``frames_u8`` [B, h, w, 3]; ``kernel`` [8, 8, 3, F] + ``bias`` [F] are
    the stem conv's own parameters (models/cnn_detector.py: _PatchifyStem —
    HWIO, k = ky*24 + kx*3 + c).  Returns relu activations
    [B, h_out/8, w_out/8, F] in ``dtype`` — bit-compatible input for
    Conv_1 of the v3 trunk.

    Both passes are CONVS so XLA keeps the overlapping windows on chip
    (see the module docstring for the design rationale); replicate
    padding is applied
    algebraically via small linear correction terms, so neither the u8
    frame nor the [B, h, w_out/8, 24] intermediate is ever copied.
    """
    b, h, w, _ = frames_u8.shape
    f = kernel.shape[-1]
    n, sb = plan.n, plan.sb
    x = frames_u8
    if plan.w_pad > w:  # width alignment pad only (zero for GTSDB 1360)
        x = jnp.concatenate(
            [x, jnp.repeat(x[:, :, -1:], plan.w_pad - w, axis=2)], axis=2)

    # ---- width: a 3-tap conv over the BLOCK grid.  The frame reshapes
    # freely to [b, h, g_w, 3n] (one n-column block per position, channels
    # = (col, c)); block g's upscale window is its own n columns plus one
    # column from each neighbor block, so the whole banded pass is a
    # [1, 3] conv with K = 9n, O = sb*24 — XLA tiles it with no
    # materialized window tensor (unlike the concat/einsum formulations
    # PARITY.md round 5 rejected).  Output
    # channels are ordered (t, kx, c), so [.., g_w, sb*24] reshapes freely
    # to the [b, h, w_out/8, 24] NHWC layout the height conv consumes.
    from jax import lax

    g_w = plan.w_pad // n
    xr = x.reshape(b, h, g_w, 3 * n).astype(dtype)
    kw = jnp.asarray(_width_conv_weights(plan)).astype(dtype)
    dnw = lax.conv_dimension_numbers(xr.shape, kw.shape,
                                     ("NHWC", "HWIO", "NHWC"))
    y = lax.conv_general_dilated(xr, kw, (1, 1), ((0, 0), (1, 1)),
                                 dimension_numbers=dnw)  # [b, h, g_w, sb*24]
    y = (y * jnp.asarray(1.0 / 255.0, dtype)
         - jnp.asarray(0.5, dtype))
    wq = plan.w_out // _PATCH
    y = y.reshape(b, h, wq, 3 * _PATCH)      # [b, h, j, q]: NHWC, free

    # The conv's zero padding dropped the replicate-column contributions
    # of the two edge blocks.  Everything downstream is LINEAR, so instead
    # of patching them into y (an in-place add that copies the whole
    # 1.2 GB tensor at batch 128), the corrections become tiny
    # [b, h, sb, 24] tensors pushed through the same height stage and
    # added on its 240x-smaller output.  Normalized WITHOUT the -0.5
    # (the affine constant lives in the main term only).
    taps = jnp.asarray(_superblock_taps(plan.t, plan.a, sb, n))
    eyec = jnp.eye(3, dtype=jnp.float32)
    wl = jnp.einsum("tk,cd->ctkd", taps[:, :, 0], eyec,
                    precision=_HI).reshape(3, sb * 3 * _PATCH)
    wr = jnp.einsum("tk,cd->ctkd", taps[:, :, n + 1], eyec,
                    precision=_HI).reshape(3, sb * 3 * _PATCH)
    scale = np.float32(1.0 / 255.0)
    cl = jnp.einsum("bhc,cm->bhm", xr[:, :, 0, :3].astype(jnp.float32),
                    wl * scale, precision=_HI
                    ).reshape(b, h, sb, 3 * _PATCH).astype(dtype)
    cr = jnp.einsum("bhc,cm->bhm", xr[:, :, -1, 3 * n - 3:]
                    .astype(jnp.float32), wr * scale, precision=_HI
                    ).reshape(b, h, sb, 3 * _PATCH).astype(dtype)

    # ---- height + stem: ONE strided conv against the composite
    # tap x kernel weights (kernel [n+2, 1, 24, sb*F], stride n) — XLA's
    # conv lowering tiles the overlapping windows itself instead of an
    # explicit window relayout (PARITY.md r5).
    # The replicate padding is algebraic: the conv zero-pads (native,
    # free), and the windows that touch padding get their edge rows added
    # back as tiny outer-product corrections.
    k0 = kernel.reshape(_PATCH, 3 * _PATCH, f).astype(jnp.float32)
    kh = jnp.einsum("sku,kqf->uqsf", taps, k0,
                    precision=_HI)                   # [n+2, 24, sb, f]
    kh_conv = kh.reshape(n + 2, 1, 3 * _PATCH, sb * f).astype(dtype)
    g_h = plan.h_pad // n

    def hstage(t):
        """Height conv + replicate-row corrections (linear in t)."""
        dn = lax.conv_dimension_numbers(t.shape, kh_conv.shape,
                                        ("NHWC", "HWIO", "NHWC"))
        o = lax.conv_general_dilated(
            t, kh_conv, (n, 1), ((1, plan.h_pad + 1 - h), (0, 0)),
            dimension_numbers=dn)                    # [b, g_h, jw, sb*f]
        # top: window 0's u=0 tap is native row -1 == row 0 (replicate)
        top = jnp.einsum("bjq,qm->bjm", t[:, 0].astype(jnp.float32),
                         kh[0].reshape(3 * _PATCH, sb * f), precision=_HI)
        o = o.at[:, 0].add(top.astype(dtype))
        # bottom: windows whose rows fall past the frame read the
        # replicate rows (all equal row h-1); one summed term per window
        for i in range(g_h - 1, -1, -1):
            missing = [u for u in range(n + 2) if n * i + u - 1 >= h]
            if not missing:
                break
            kh_i = kh[missing[0]:].sum(axis=0).reshape(3 * _PATCH, sb * f)
            corr = jnp.einsum("bjq,qm->bjm",
                              t[:, h - 1].astype(jnp.float32), kh_i,
                              precision=_HI)
            o = o.at[:, i].add(corr.astype(dtype))
        return o

    out = hstage(y)
    out = out.at[:, :, :sb].add(hstage(cl))
    out = out.at[:, :, -sb:].add(hstage(cr))
    out = out.reshape(b, g_h, wq, sb, f).transpose(0, 1, 3, 2, 4)
    out = out.reshape(b, g_h * sb, wq, f)
    return jax.nn.relu(out + bias.astype(dtype))


def _width_conv_weights(plan: FusedUpscalePlan) -> np.ndarray:
    """[1, 3, 3n, sb*24] HWIO kernel for the width pass as a 3-tap conv
    over the n-column block grid.

    Input channels are (col-in-block, c); tap dg=0 is the PREVIOUS block
    (only its last column carries weight — the u=0 bilinear tap), dg=1 the
    block itself (u = 1..n), dg=2 the next block (first column, u = n+1).
    Output channels are (t, kx, c) so the conv result reshapes freely to
    the [.., w_out/8, 24] layout."""
    n, sb = plan.n, plan.sb
    taps = _superblock_taps(plan.t, plan.a, sb, n)     # [sb, 8, n+2]
    w = np.zeros((3, n, 3, sb, _PATCH, 3), np.float64)  # [dg,col,c,t,k,c']
    for t in range(sb):
        for k in range(_PATCH):
            for c in range(3):
                w[0, n - 1, c, t, k, c] = taps[t, k, 0]
                for u in range(1, n + 1):
                    w[1, u - 1, c, t, k, c] = taps[t, k, u]
                w[2, 0, c, t, k, c] = taps[t, k, n + 1]
    return w.reshape(1, 3, 3 * n, sb * _PATCH * 3).astype(np.float32)
