"""MSER region proposal as a data-parallel level-sliced sweep.

OpenCV's MSER builds a sequential component tree (union-find over a pixel
flood).  That shape is hostile to SIMD hardware; this module re-derives
maximally-stable regions in a data-parallel form built around one idea:

**Composite seed keys.**  Every pixel carries the permanent key
``intensity * H*W + flat_index``.  The component-wise minimum of these keys
(computed by the roll-based propagation kernel, :func:`..ops.ccl.
propagate_min_keys`) identifies each component by its *darkest* pixel — the
flood-fill seed of the classic algorithm.  That anchor makes the whole
stability bookkeeping elementwise:

* canonical mask: a pixel is its component's anchor iff ``key % HW == idx``;
* component area at the anchor: the scatter-add count table is indexed by
  anchor pixel, so the anchor reads its own area *in place*;
* Matas variation ``V = (A[l+Δ] - A[l-Δ]) / A[l]`` evaluated on the seed
  chain: ``A[l±Δ]`` are per-pixel area maps read at the same anchor pixel —
  the seed is in the mask from its birth level on, so the history is always
  the seed-path sub-component (no scatter-max over components needed).

The level sweep is one ``lax.scan`` (warm-started keys; masks only grow), a
sliding window of per-pixel area/variation maps evaluates stability two
levels behind the sweep front, and candidates exit as one compact byte map
per level (quantized stability), top-k'd into the padded proposal tensor.
Both polarities run stacked as a leading batch dim (dark-on-bright and
bright-on-dark, matching OpenCV's two-pass grayscale behaviour).

Per level the only non-elementwise op is one scatter-add (area counts
landing at anchor pixels) — everything else is rolls and vector math.

That pixel-area sweep is the ``--pixel_area_stability`` mode.  The default
sweep (:func:`bbox_level_sweep`) replaces the per-level scatter with
bounding-box-area stability: four extent channels propagate beside the
keys, so every per-level quantity is elementwise at the anchor pixel.

Replaces `cv2.MSER_create` / `mser.detectRegions` (`Deteción de
Objetos/source.py:639,114`; `Reconocimiento de Objetos/source.py:43,50`).
Exact region sets are not bit-reproducible vs OpenCV (tie-breaking and
per-level evaluation differ); parity is validated at the detection-quality
level (proposal recall and end-to-end F1/AP over the GTSDB frames).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import MSERConfig
from . import flood_cuda
from .ccl import propagate_min_keys, run_reduce

# Static window size for bbox refinement; sign-scale components at the
# default max_area=2000 fit comfortably in 128x128.
_WIN = 128
# Flood radius for refinement = 2 * _REFINE_ROLLS (two roll rounds in
# propagate_min_keys); 48 covers any component that fits the window.
_REFINE_ROLLS = 48


def _level_sweep(im2: jnp.ndarray, levels, cfg: MSERConfig, d_idx: int):
    """Scan over thresholds; emit per-level quantized-stability byte maps.

    im2: [2, H, W] int32 (polarity-stacked intensities).
    Returns sb u8 [L, 2, H*W]: 0 = not a candidate, else 255 - quantized V
    (higher byte = more stable), emitted at each component's anchor pixel
    for level ``levels[t] - (d_idx+1)*step`` at scan step t.
    """
    p, h, w = im2.shape
    hw = h * w
    big = 256 * hw
    d = d_idx
    idx = jnp.arange(hw, dtype=jnp.int32).reshape(1, h, w)
    keys0 = im2 * hw + idx  # permanent per-pixel composite key
    pol_off = (jnp.arange(p, dtype=jnp.int32) * (hw + 1)).reshape(p, 1, 1)
    levels_arr = jnp.asarray(levels, dtype=jnp.int32)
    inf = jnp.float32(jnp.inf)

    # Forward variation (matching the classic implementation):
    #   V[l] = (A[l+d] - A[l]) / A[l]
    # so a region is eligible from its birth level on.
    #
    # All per-level state is *anchor-resident*: the scatter-add count table
    # is indexed by anchor pixel, so position q holds its component's area
    # iff q is still that component's anchor (0 otherwise).  The seed chain
    # of an anchor therefore reads every A[l'] at its own position — no
    # gather.  When a chain is absorbed by a darker seed, its slot drops to
    # 0 and V becomes +inf, which is exactly the classic semantics (the
    # region merged into something much larger -> unstable).
    #
    # Sliding rings (oldest first):
    #   a_ring [d+1] = A[t-d-1] .. A[t-1]   anchor-resident component areas
    #   v_ring [2]   = V[t-d-2], V[t-d-1]
    # At step t we compute A[t] and V[t-d], then emit candidates for level
    # t-d-1 (centre V with both level-neighbours known).
    def step(carry, level):
        keys_prev, a_ring, v_ring, last_emit = carry
        mask = im2 <= level
        keys_in = jnp.where(mask, jnp.minimum(keys_prev, keys0), big)
        # frames are padded with intensity 255, so masks below level 255
        # never touch the border: rolls are edge-safe without guards
        keys = propagate_min_keys(
            keys_in, mask, big,
            num_rolls=cfg.ccl_iters, num_jumps=cfg.ccl_jumps, edges_safe=True,
        )
        anchor = keys % hw

        # area counts scattered to anchor pixels (dump slot per polarity)
        slot = jnp.where(mask, anchor, hw) + pol_off
        counts = jnp.zeros((p * (hw + 1),), jnp.int32).at[slot.reshape(-1)].add(1)
        a_cur = counts.reshape(p, hw + 1)[:, :hw].reshape(p, h, w)
        a_cur = jnp.minimum(a_cur, 65535).astype(jnp.uint16)

        # V[t-d] on the seed chain (at anchors alive both at t-d and t)
        a_td = a_ring[1].astype(jnp.float32)  # A[t-d]
        a_t = a_cur.astype(jnp.float32)
        v_new = jnp.where(
            (a_td > 0) & (a_t > 0), (a_t - a_td) / jnp.maximum(a_td, 1.0), inf
        )

        # candidates for level c = t-d-1
        v_c = v_ring[1]
        area_c = a_ring[0].astype(jnp.int32)  # A[t-d-1]; > 0 iff anchor at c
        cand = (
            (area_c >= cfg.min_area)
            & (area_c <= cfg.max_area)
            & (v_c < cfg.max_variation)
            & (v_c <= v_ring[0])
            & (v_c <= v_new)
        )
        # min_diversity (cv2 default 0.2): prune nested re-emissions on the
        # same anchor chain unless the region grew enough since the last
        # emitted candidate (matches the bbox-area sweep's rule)
        area_f = area_c.astype(jnp.float32)
        diverse = (last_emit <= 0.0) | (
            (area_f - last_emit)
            >= cfg.min_diversity * jnp.maximum(area_f, 1.0)
        )
        cand = cand & diverse
        last_emit = jnp.where(cand, area_f, last_emit)
        qv = jnp.clip(254.0 - jnp.floor(v_c * 253.0), 1.0, 254.0)
        sb = jnp.where(cand, qv, 0.0).astype(jnp.uint8).reshape(p, hw)

        a_ring = jnp.concatenate([a_ring[1:], a_cur[None]], axis=0)
        v_ring = jnp.stack([v_ring[1], v_new])
        return (keys, a_ring, v_ring, last_emit), sb

    init = (
        jnp.where(im2 < 0, keys0, big),  # varying-typed "all background"
        jnp.tile(jnp.zeros_like(im2, dtype=jnp.uint16)[None], (d + 1, 1, 1, 1)),
        jnp.tile(jnp.full_like(im2, jnp.inf, dtype=jnp.float32)[None], (2, 1, 1, 1)),
        jnp.zeros_like(im2, dtype=jnp.float32),  # last-emitted area
    )
    _, sb = jax.lax.scan(step, init, levels_arr)
    return sb  # [L, 2, HW]


def packing_bits(pool: int, num_levels: int) -> tuple[int, int]:
    """(in-block position bits, level bits) of the packed candidate value."""
    pool = max(1, pool)
    bits = max((pool * pool - 1).bit_length(), 1)
    lbits = max((num_levels - 1).bit_length(), 1)
    return bits, lbits


def _bbox_sweep(im2: jnp.ndarray, cfg: MSERConfig, d_idx: int,
                num_levels: int, full: bool):
    """Bounding-box-area level sweep over a 255-bordered polarity stack.

    Shared body of :func:`bbox_level_sweep` (``full=False``: running max
    of the packed ``(stability byte << lbits) | level`` per pixel) and
    :func:`bbox_level_sweep_full` (``full=True``: the per-level byte maps).

    Per level, the component key (min; the anchor is the darkest pixel,
    exactly as in :func:`_level_sweep`) and the bbox extents ymin/xmin
    (min) and ymax/xmax (max) propagate under the level's mask; the Matas
    variation ``V = (A[t] - A[t-d]) / A[t-d]`` is evaluated on bbox areas
    read elementwise at anchor pixels, and candidates are emitted at the
    anchor for level ``t*step - (d+1)*step`` as a quantized-stability byte.

    Divergence from OpenCV: stability and the area window use the
    component's *bounding-box* area rather than its pixel count (a pixel
    count needs a scatter per level).  Bbox area upper bounds pixel area,
    so ``min_area`` transfers unchanged while the upper bound is scaled by
    ``bbox_area_cap_scale``; the exact pixel-area window is re-applied to
    the refined component (:func:`mser_regions`).

    With ``cfg.sweep_extent_only`` only keys + the vertical extents
    propagate and the area proxy is the squared height: traffic-sign
    candidates are near-square (the pipeline's aspect filter keeps
    0.8 < w/h < 1.2, `Deteción de Objetos/source.py:155-174`), so squared
    height tracks bbox area on everything that can survive.
    """
    p, h, w = im2.shape
    hw = h * w
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d = d_idx
    nring = d + 1
    extent_only = cfg.sweep_extent_only
    min_area = float(cfg.min_area)
    max_area = float(cfg.max_area) * cfg.bbox_area_cap_scale
    num_rolls = 2 * cfg.ccl_iters
    _, lbits = packing_bits(cfg.topk_pool, num_levels)

    big = jnp.int32(256 * hw)
    bigc = jnp.int32(1 << 28)
    neg = jnp.int32(-1)
    inf = jnp.float32(jnp.inf)
    im = im2.astype(jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (p, h, w), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (p, h, w), 2)
    keys0 = im * hw + rows * w + cols
    # the first/last rows stay out of every mask: with the 255 border this
    # only clips the degenerate >= 255 flush levels, and it keeps roll
    # wraparound from fusing opposite edges there
    inner = (rows > 0) & (rows < h - 1)

    # extent channels: (is_min, fill); extent_only drops the x extents
    chans = [(True, bigc), (False, neg)]  # ymin, ymax
    if not extent_only:
        chans += [(True, bigc), (False, neg)]  # xmin, xmax
    coords = [rows, rows] + ([] if extent_only else [cols, cols])

    def nb(x, op):
        return op(op(jnp.roll(x, 1, -2), jnp.roll(x, -1, -2)),
                  op(jnp.roll(x, 1, -1), jnp.roll(x, -1, -1)))

    def roll_pass(keys, ext, mask):
        """One radius-1 pass over keys then every extent channel."""
        knew = jnp.where(mask, jnp.minimum(keys, nb(keys, jnp.minimum)), big)
        live = mask & (knew >= 0)
        out = []
        for x, (is_min, fill) in zip(ext, chans):
            op = jnp.minimum if is_min else jnp.maximum
            out.append(jnp.where(live, op(x, nb(x, op)), fill))
        changed = jnp.any(knew != keys)
        for a, b in zip(out, ext):
            changed = changed | jnp.any(a != b)
        return knew, out, changed

    def axis_resolve(keys, ext, mask, axis):
        """Each mask run along ``axis`` takes its full-run key min and
        extents in one segmented scan (live pixels only for extents)."""
        live = mask & (keys >= 0)
        knew = run_reduce(keys, mask, big, axis)
        live2 = mask & (knew >= 0)
        out = []
        for x, (is_min, fill) in zip(ext, chans):
            op = jnp.minimum if is_min else jnp.maximum
            r = run_reduce(jnp.where(live, x, fill), mask, fill, axis, op)
            out.append(jnp.where(live2, r, fill))
        return knew, out

    def propagate(keys, ext, mask):
        if cfg.scan_passes > 0:
            for _ in range(cfg.scan_passes):
                keys, ext = axis_resolve(keys, ext, mask, -1)
                keys, ext = axis_resolve(keys, ext, mask, -2)
            return axis_resolve(keys, ext, mask, -1)

        # warm-started state is monotone in every channel, so a pass that
        # changes nothing is a true fixed point: exit early below the cap
        def body(c):
            it, k, e, _ = c
            k, e, _ = roll_pass(k, e, mask)
            k, e, changed = roll_pass(k, e, mask)
            return it + 2, k, e, changed

        _, keys, ext, _ = jax.lax.while_loop(
            lambda c: (c[0] < num_rolls) & c[3], body,
            (jnp.int32(0), keys, ext, jnp.bool_(True)))
        return keys, ext

    def step(carry, t):
        keys, ext, aring, vring, last, acc = carry
        level = t * s
        mask = (im <= level) & inner
        keys = jnp.where(mask, jnp.minimum(keys, keys0), big)
        ext = [jnp.where(mask, (jnp.minimum if is_min else jnp.maximum)(x, c),
                         fill)
               for x, c, (is_min, fill) in zip(ext, coords, chans)]
        # Dead-region pruning makes the early exit fire: a component whose
        # bbox area exceeds the cap can never emit again (areas only grow),
        # so its anchor takes key -1 at the end of its level; -1 spreads by
        # the same min propagation and freezes the extents at their fill.
        keys, ext = propagate(keys, ext, mask)

        # anchor == own key is the component minimum; bbox area at anchors
        # (f32 before the product: dead/sentinel extents overflow int32)
        anchor = mask & (keys == keys0)
        hgt = (ext[1] - ext[0] + 1).astype(jnp.float32)
        if extent_only:
            bb = hgt * hgt
        else:
            bb = hgt * (ext[3] - ext[2] + 1).astype(jnp.float32)
        bb = jnp.minimum(bb, 65535.0)
        a_cur = jnp.where(anchor, bb, 0.0)
        keys = jnp.where(anchor & (bb > max_area), neg, keys)

        # rings: areas A[t-d-1..t-1] in d+1 slots, V[t-d-2], V[t-d-1] in 2
        area_c = aring[t % nring].astype(jnp.float32)           # A[t-d-1]
        a_td = aring[(t + nring - d % nring) % nring].astype(jnp.float32)
        s_v_new = (t + 2 * nring - d) % 2
        v_c = vring[1 - s_v_new].astype(jnp.float32)            # V[t-d-1]
        v_prev = vring[s_v_new].astype(jnp.float32)             # V[t-d-2]
        v_new = jnp.where((a_td > 0.0) & (a_cur > 0.0),
                          (a_cur - a_td) / jnp.maximum(a_td, 1.0), inf)
        cand = ((area_c >= min_area) & (area_c <= max_area)
                & (v_c < cfg.max_variation) & (v_c <= v_prev)
                & (v_c <= v_new))
        # min_diversity (OpenCV default 0.2): suppress nested re-emissions
        # on the same anchor chain unless the region grew enough since the
        # last emitted candidate
        lastf = last.astype(jnp.float32)
        diverse = (lastf <= 0.0) | (
            (area_c - lastf) >= cfg.min_diversity * jnp.maximum(area_c, 1.0))
        cand = cand & diverse
        last = jnp.where(cand, area_c, lastf).astype(jnp.bfloat16)
        qv = jnp.clip(254.0 - jnp.floor(v_c * 253.0), 1.0, 254.0)
        qv = jnp.where(cand, qv, 0.0)

        # rings are bf16: areas <= 65535 and variation ratios tolerate the
        # 8-bit mantissa (the stability byte's quantization step is of the
        # same order)
        aring = aring.at[t % nring].set(a_cur.astype(jnp.bfloat16))
        vring = vring.at[s_v_new].set(v_new.astype(jnp.bfloat16))
        if full:
            return (keys, ext, aring, vring, last, acc), \
                qv.astype(jnp.int32).astype(jnp.uint8)
        acc = jnp.maximum(acc, qv.astype(jnp.int32) * (1 << lbits) + t)
        return (keys, ext, aring, vring, last, acc), None

    init = (
        jnp.full((p, h, w), big),
        [jnp.full((p, h, w), fill) for _, fill in chans],
        jnp.zeros((nring, p, h, w), jnp.bfloat16),
        jnp.full((2, p, h, w), jnp.inf, jnp.bfloat16),
        jnp.zeros((p, h, w), jnp.bfloat16),
        jnp.zeros((p, h, w), jnp.int32),
    )
    carry, per_level = jax.lax.scan(step, init,
                                    jnp.arange(num_levels, dtype=jnp.int32))
    return per_level if full else carry[-1]


def bbox_level_sweep(im2: jnp.ndarray, cfg: MSERConfig, d_idx: int,
                     num_levels: int) -> jnp.ndarray:
    """[P, H, W] 255-bordered stack -> level-collapsed candidate map.

    Returns int32 [P, H, W]: per pixel, ``(stability_byte << lbits) |
    level_idx`` maximized over all levels (level_idx alone, i.e. stability
    0, where no candidate).  Decode with :func:`packing_bits`; level_idx t
    holds the candidates for threshold level ``t*step - (d_idx+1)*step``.
    """
    return _bbox_sweep(im2, cfg, d_idx, num_levels, full=False)


def bbox_level_sweep_full(im2: jnp.ndarray, cfg: MSERConfig, d_idx: int,
                          num_levels: int) -> jnp.ndarray:
    """[P, H, W] -> stability bytes [P, L, H, W]: the per-level maps that
    :func:`bbox_level_sweep` collapses (test oracle)."""
    return _bbox_sweep(im2, cfg, d_idx, num_levels, full=True).transpose(
        1, 0, 2, 3)


def flood_bbox(mask: jnp.ndarray, seeds_yx: jnp.ndarray, big: int,
               passes: int):
    """Seed flood + bbox/area of the seed's component per window.

    ``mask`` [N, H, W] bool with a False border ring, ``seeds_yx`` [N, 2]
    int32.  Each pass resolves every horizontal then every vertical mask
    run completely (a run is reached when any of its pixels is), so
    convergence is bounded by the component's zigzag complexity (1-2
    passes for convex sign-like blobs), not its diameter.  Returns
    (ymin, ymax, xmin, xmax, area), each int32 [N]; an empty component
    (seed off the mask) gives (big, -1, big, -1, 0).

    On CUDA devices this lowers to the shared-memory kernel of
    ``.flood_cuda``; elsewhere to the plain segmented-scan version.
    """
    plain = functools.partial(_flood_bbox_scan, big=big, passes=passes)
    if not flood_cuda.available():
        return plain(mask, seeds_yx)
    cuda = functools.partial(flood_cuda.flood_bbox_cuda, big=big,
                             passes=passes)
    return jax.lax.platform_dependent(mask, seeds_yx, cuda=cuda,
                                      default=plain)


def _flood_bbox_scan(mask, seeds_yx, *, big: int, passes: int):
    """The plain segmented-scan flood (see :func:`flood_bbox`)."""
    _, h, w = mask.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
    seed = ((rows == seeds_yx[:, 0, None, None])
            & (cols == seeds_yx[:, 1, None, None]))
    k = jnp.where(mask & seed, 0, big)
    for _ in range(passes):
        k = run_reduce(k, mask, big, -1)
        k = run_reduce(k, mask, big, -2)
    return _component_bbox(run_reduce(k, mask, big, -1) == 0, big)


def _component_bbox(sel: jnp.ndarray, big: int):
    """[N, H, W] bool -> (ymin, ymax, xmin, xmax, area) of the True set."""
    _, h, w = sel.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
    return (jnp.min(jnp.where(sel, rows, big), axis=(1, 2)),
            jnp.max(jnp.where(sel, rows, -1), axis=(1, 2)),
            jnp.min(jnp.where(sel, cols, big), axis=(1, 2)),
            jnp.max(jnp.where(sel, cols, -1), axis=(1, 2)),
            jnp.sum(sel.astype(jnp.int32), axis=(1, 2)))


def _refine_boxes(im2: jnp.ndarray, seeds_yx: jnp.ndarray, levels: jnp.ndarray,
                  polarity: jnp.ndarray, num_rolls: int, seed_slack: int = 0,
                  scan_passes: int = 0, win: int = _WIN):
    """Per candidate: local flood fill in a window centred on its anchor at
    its level; bbox + pixel area of the seed's component.

    -> (boxes_xywh [N, 4] int32, areas [N] int32).

    Structure: vmapped window extraction (one dynamic slice each), then ONE
    batched jump-free seed-indicator propagation over the [N, win, win]
    stack — min-propagating a {0 at seed, BIG elsewhere} map under the mask
    reaches exactly the seed's connected component and needs no label
    gather at the end.
    """
    _, h, w = im2.shape
    win_h = min(win, h)
    win_w = min(win, w)
    big = win_h * win_w + 1

    # static inner ring: window borders must not wrap during rolls
    import numpy as _np
    inner = _np.zeros((win_h, win_w), bool)
    inner[1:-1, 1:-1] = True
    inner = jnp.asarray(inner)

    def extract(seed, level, pol):
        y, x = seed[0], seed[1]
        y0 = jnp.clip(y - win_h // 2, 0, max(h - win_h, 0))
        x0 = jnp.clip(x - win_w // 2, 0, max(w - win_w, 0))
        win = jax.lax.dynamic_slice(im2, (pol, y0, x0), (1, win_h, win_w))[0]
        sy, sx = y - y0, x - x0
        if seed_slack > 0:
            # seeds mapped from a downscaled sweep land near, not on, the
            # native-res extremum: snap to the darkest pixel in the slack
            # patch so the seed is inside the native mask at this level
            k = 2 * seed_slack + 1
            py = jnp.clip(sy - seed_slack, 0, win_h - k)
            px = jnp.clip(sx - seed_slack, 0, win_w - k)
            patch = jax.lax.dynamic_slice(win, (py, px), (k, k))
            off = jnp.argmin(patch.reshape(-1))
            sy = py + off // k
            sx = px + off - (off // k) * k
        return win, y0, x0, sy, sx

    wins, y0s, x0s, sys_, sxs = jax.vmap(extract)(seeds_yx, levels, polarity)

    mask = (wins <= levels[:, None, None]) & inner[None]
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, win_h, win_w), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, win_h, win_w), 2)
    # flood the seed's component: full-component segmented-scan resolves
    # when scan_passes > 0, else radius 2*num_rolls (two roll rounds)
    if scan_passes > 0:
        ymin, ymax, xmin, xmax, area = flood_bbox(
            mask, jnp.stack([sys_, sxs], axis=-1), big, scan_passes)
    else:
        seed_map = jnp.where(
            (rows == sys_[:, None, None]) & (cols == sxs[:, None, None]),
            jnp.int32(0),
            jnp.int32(big),
        )
        reach = propagate_min_keys(seed_map, mask, big, num_rolls=num_rolls,
                                   num_jumps=0, edges_safe=True)
        ymin, ymax, xmin, xmax, area = _component_bbox(reach == 0, big)
    boxes = jnp.stack(
        [x0s + xmin, y0s + ymin, xmax - xmin + 1, ymax - ymin + 1], axis=-1
    )
    return boxes, area


@functools.partial(jax.jit, static_argnames=("cfg",))
def mser_regions(gray: jnp.ndarray, cfg: MSERConfig):
    """Detect MSER proposals on one uint8 [H, W] frame.

    Returns (boxes_xywh int32 [max_regions, 4], valid bool [max_regions]),
    most-stable first.
    """
    def pad_pol(gr):
        """Polarity stack with the edge-safe 255 border: [2, H+2, W+2]."""
        g = gr.astype(jnp.int32)
        both = jnp.stack([g, 255 - g])
        # 1-px border at intensity 255 (both polarities): keeps every
        # sub-255 threshold mask off the border so roll wraparound can't
        # leak between opposite edges (propagate_min_keys edge handling)
        return jnp.pad(both, ((0, 0), (1, 1), (1, 1)), constant_values=255)

    def pooled_topk_packed(cmap, c, levels, d_idx):
        """Candidate selection on the sweep's level-collapsed map.

        ``cmap`` is :func:`bbox_level_sweep`'s [2, H, W] int32 output — per
        pixel, (stability byte << lbits | level) maximized across levels.
        Here the map is max-pooled
        over (pool x pool) spatial blocks with the in-block position packed
        into the low bits, then top-k'd — pool^2 x less top-k work for the
        same stability ranking (block collisions merge anchors < pool px
        apart, which dedup would merge anyway).
        -> (seeds, level_vals, pol_idx, valid).
        """
        pool = max(1, c.topk_pool)
        nl = len(levels)
        s = c.level_step if c.level_step > 0 else c.delta
        bits, lbits = packing_bits(pool, nl)
        p2, h, w = cmap.shape  # h, w are pool multiples
        rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        local = (rows % pool) * pool + cols % pool
        comb = cmap * (1 << bits) + local[None]
        h4, w4 = h // pool, w // pool
        best = comb.reshape(p2, h4, pool, w4, pool).max(axis=(2, 4))

        n = c.max_regions
        top_vals, top_idx = jax.lax.top_k(best.reshape(-1), n)
        local = top_vals & ((1 << bits) - 1)
        t_idx = (top_vals >> bits) & ((1 << lbits) - 1)
        valid = (top_vals >> (bits + lbits)) > 0  # stability byte > 0

        per_pol = h4 * w4
        pol_idx = top_idx // per_pol
        rem = top_idx - pol_idx * per_pol
        y4 = rem // w4
        x4 = rem - y4 * w4
        y = y4 * pool + local // pool
        xx = x4 * pool + local % pool
        level_vals = jnp.maximum(
            jnp.asarray(levels, jnp.int32)[jnp.clip(t_idx, 0, nl - 1)]
            - (d_idx + 1) * s,
            0,
        )
        seeds = jnp.stack([y, xx], axis=-1).astype(jnp.int32)
        return seeds, level_vals, pol_idx, valid

    def sweep_candidates(gr, c):
        """Run the level sweep on one frame; return top-k candidates.

        -> (seeds_yx [N,2] padded coords, level_vals [N], pol_idx [N],
            valid [N], im2 padded stack)."""
        h0, w0 = gr.shape
        s = c.level_step if c.level_step > 0 else c.delta
        d_idx = max(1, round(c.delta / s))
        # evaluate every s levels; emission lags the sweep front by d+1
        # steps, so run the sweep past 255 to flush the last real levels
        levels = list(range(0, 256 + (d_idx + 1) * s + 1, s))
        im2 = pad_pol(gr)
        h, w = h0 + 2, w0 + 2
        hw = h * w

        if c.fused_sweep and c.ccl_jumps == 0:
            # bbox-area sweep (pointer jumps are gathers; that sweep has
            # none).  Frames pad to pool multiples with the 255 background
            # for the pooled top-k.
            pool = max(1, c.topk_pool)
            hp, wp = -(-h // pool) * pool, -(-w // pool) * pool
            padded = jnp.pad(im2, ((0, 0), (0, hp - h), (0, wp - w)),
                             constant_values=255)
            best = bbox_level_sweep(padded, c, d_idx, len(levels))
            seeds, level_vals, pol_idx, valid = pooled_topk_packed(
                best, c, levels, d_idx
            )
            return seeds, level_vals, pol_idx, valid, im2, True

        sb = _level_sweep(im2, levels, c, d_idx)  # [L, 2, HW]
        n = c.max_regions
        flat = sb.astype(jnp.int32).reshape(-1)
        top_vals, top_idx = jax.lax.top_k(flat, n)
        valid = top_vals > 0

        per_level = 2 * hw
        t_idx = top_idx // per_level
        rem = top_idx - t_idx * per_level
        pol_idx = rem // hw
        q = rem - pol_idx * hw
        # sb at scan step t describes level levels[t] - (d_idx+1)*s
        level_vals = jnp.maximum(
            jnp.asarray(levels, jnp.int32)[t_idx] - (d_idx + 1) * s, 0
        )
        seeds = jnp.stack([q // w, q - (q // w) * w], axis=-1).astype(jnp.int32)
        return seeds, level_vals, pol_idx, valid, im2, False

    ds = max(1, cfg.downscale)
    if ds > 1:
        # sweep on the 2x2-mean image (4x cheaper), then refine candidate
        # bboxes on the native-resolution image for tight boxes
        h0, w0 = gray.shape
        hc, wc = (h0 // ds) * ds, (w0 // ds) * ds
        g_small = (
            gray[:hc, :wc]
            .reshape(hc // ds, ds, wc // ds, ds)
            .astype(jnp.int32)
            .mean(axis=(1, 3))
        ).astype(jnp.uint8)
        import dataclasses as _dc

        sub_cfg = _dc.replace(
            cfg,
            min_area=max(cfg.min_area // (ds * ds), 1),
            max_area=max(cfg.max_area // (ds * ds), 1),
            downscale=1,
        )
        if cfg.sweep_res_pipeline:
            # low-res refine: the sweep input is the downsampled enhanced
            # frame as usual, but the refinement flood also runs at sweep
            # resolution (64-px windows, ~4x less flood + extraction work)
            # with boxes scaled back to native coords.  (Relocating the
            # CLAHE chain itself to low res was measured and rejected:
            # full-set F1 0.215 -> 0.139 — the native-res equalization is
            # load-bearing for the level stack; see PARITY.md round 3.)
            seeds_s, level_vals, pol_idx, valid, im2_s, bbox = (
                sweep_candidates(g_small, sub_cfg)
            )
            boxes, areas = _refine_boxes(
                im2_s, seeds_s, level_vals, pol_idx, _REFINE_ROLLS,
                scan_passes=cfg.refine_scan_passes, win=64,
            )
            if bbox:
                valid = (valid & (areas >= sub_cfg.min_area)
                         & (areas <= sub_cfg.max_area))
            boxes = boxes.at[:, 0].add(-1).at[:, 1].add(-1)  # unpad
            boxes = boxes * ds  # small -> native coords (x, y, w, h)
            boxes = jnp.where(valid[:, None], boxes, 0)
            return boxes.astype(jnp.int32), valid
        seeds_s, level_vals, pol_idx, valid, _, bbox = sweep_candidates(
            g_small, sub_cfg
        )
        im2 = pad_pol(gray)
        seeds = (seeds_s - 1) * ds + ds // 2 + 1  # block centre, native pad
        boxes, areas = _refine_boxes(im2, seeds, level_vals, pol_idx,
                                     _REFINE_ROLLS, seed_slack=ds,
                                     scan_passes=cfg.refine_scan_passes)
        if bbox:
            # the bbox sweep's candidate filter is on *bbox* area; enforce
            # the reference's exact pixel-area window on the native-res
            # component extracted here (culls sparse/thin junk candidates)
            valid = valid & (areas >= cfg.min_area) & (areas <= cfg.max_area)
        boxes = boxes.at[:, 0].add(-1).at[:, 1].add(-1)
        boxes = jnp.where(valid[:, None], boxes, 0)
        return boxes.astype(jnp.int32), valid

    seeds, level_vals, pol_idx, valid, im2, bbox = sweep_candidates(gray, cfg)
    boxes, areas = _refine_boxes(im2, seeds, level_vals, pol_idx,
                                 _REFINE_ROLLS,
                                 scan_passes=cfg.refine_scan_passes)
    if bbox:
        valid = valid & (areas >= cfg.min_area) & (areas <= cfg.max_area)
    # back to unpadded frame coordinates
    boxes = boxes.at[:, 0].add(-1).at[:, 1].add(-1)
    boxes = jnp.where(valid[:, None], boxes, 0)
    return boxes.astype(jnp.int32), valid


def mser_regions_batch(gray_batch: jnp.ndarray, cfg: MSERConfig):
    """vmapped mser_regions: [B, H, W] -> ([B, N, 4], [B, N])."""
    return jax.vmap(lambda g: mser_regions(g, cfg))(gray_batch)
