"""Connected-components labeling as a data-parallel XLA kernel.

The classic union-find CCL is sequential; here it is a Shiloach-Vishkin
style iteration that converges in O(log*) rounds for blob-like shapes:

    1. neighbour-min:  m[q]   = min(lab[q], lab of 4-neighbours in mask)
    2. hook:           lab[r] = min(lab[r], m[q]) for every q with root r
                       (a scatter-min onto current roots)
    3. jump (x2):      lab[q] = lab[lab[q]]

Labels are flat pixel indices; the component label converges to the minimum
flat index of the component ("canonical pixel").  Background pixels carry the
sentinel HW (one past the last pixel) so scatters land in a dump slot.

This is the data-parallel replacement for the interior of OpenCV's MSER
component tree (`mser.detectRegions`, used at `Deteción de
Objetos/source.py:114`); level slicing is in :mod:`.mser`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _neighbor_min(lab2d: jnp.ndarray, mask2d: jnp.ndarray, big: int) -> jnp.ndarray:
    """Min of 4-neighbour labels (masked), same shape as lab2d."""
    pad = jnp.pad(lab2d, 1, constant_values=big)
    mpad = jnp.pad(mask2d, 1, constant_values=False)

    def nb(dy, dx):
        l = pad[1 + dy : pad.shape[0] - 1 + dy, 1 + dx : pad.shape[1] - 1 + dx]
        m = mpad[1 + dy : mpad.shape[0] - 1 + dy, 1 + dx : mpad.shape[1] - 1 + dx]
        return jnp.where(m, l, big)

    out = jnp.minimum(jnp.minimum(nb(-1, 0), nb(1, 0)), jnp.minimum(nb(0, -1), nb(0, 1)))
    return jnp.where(mask2d, jnp.minimum(lab2d, out), big)


def label_components(
    mask: jnp.ndarray,
    num_iters: int = 8,
    init_labels: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Label True-regions of a [H, W] bool mask with canonical flat indices.

    Returns int32 [H, W]; background pixels get H*W.  ``init_labels`` warm
    starts from a previous (subset) mask's labels — used by the MSER level
    sweep, where masks only grow with the threshold.
    """
    h, w = mask.shape
    big = h * w
    idx = jnp.arange(big, dtype=jnp.int32).reshape(h, w)
    lab = jnp.where(mask, idx, big)
    if init_labels is not None:
        lab = jnp.where(mask & (init_labels < big), jnp.minimum(lab, init_labels), lab)

    def body(_, lab2d):
        m = _neighbor_min(lab2d, mask, big)
        flat = lab2d.reshape(-1)
        mflat = mask.reshape(-1)
        # hook: scatter-min the improved label onto each pixel's current root
        roots = jnp.where(mflat, flat, big)
        upd = jnp.where(mflat, m.reshape(-1), big)
        flat = jnp.append(flat, jnp.int32(big))  # dump slot for background
        flat = flat.at[roots].min(upd)
        flat = flat[:-1]
        # jump twice: lab = lab[lab]
        ext = jnp.append(flat, jnp.int32(big))
        flat = jnp.where(flat < big, ext[jnp.minimum(flat, big)], big)
        ext = jnp.append(flat, jnp.int32(big))
        flat = jnp.where(flat < big, ext[jnp.minimum(flat, big)], big)
        return flat.reshape(h, w)

    lab = jax.lax.fori_loop(0, num_iters, body, lab)
    return lab


def _segmented_min_1d(vals: jnp.ndarray, mask: jnp.ndarray, big: int,
                      axis: int, reverse: bool, op=jnp.minimum) -> jnp.ndarray:
    """Running min within contiguous True-runs of ``mask`` along ``axis``.

    Classic segmented-scan semiring: elements are (value, barrier); a barrier
    (background pixel) cuts propagation.  log-depth associative_scan — pure
    vector ops, no gather/scatter.  ``op`` swaps the min for another
    idempotent monoid (``jnp.maximum`` with ``big`` its identity).
    """
    v = jnp.where(mask, vals, big)
    barrier = ~mask

    def comb(a, b):
        va, ba = a
        vb, bb = b
        return jnp.where(bb, vb, op(va, vb)), ba | bb

    out, _ = jax.lax.associative_scan(comb, (v, barrier), axis=axis % v.ndim,
                                      reverse=reverse)
    return out


def run_reduce(vals: jnp.ndarray, mask: jnp.ndarray, fill, axis: int,
               op=jnp.minimum) -> jnp.ndarray:
    """Reduce ``vals`` over each whole True-run of ``mask`` along ``axis``.

    Every run pixel gets ``op`` over its full run (forward and backward
    segmented scans combined); background pixels get ``fill``.
    """
    out = op(_segmented_min_1d(vals, mask, fill, axis, False, op),
             _segmented_min_1d(vals, mask, fill, axis, True, op))
    return jnp.where(mask, out, fill)


def label_components_scan(
    mask: jnp.ndarray,
    num_iters: int = 4,
    init_labels: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Scatter/gather-free CCL via alternating row/column segmented scans.

    Each iteration takes the full-run minimum along rows then columns; labels
    flow around corners one alternation at a time, so convergence needs
    roughly the "turn count" of the most serpentine component.  Blob/ring
    shapes (traffic signs) converge in <= 3-4 alternations; the MSER sweep
    warm-starts from the previous level which cuts it further.  Semantics
    match :func:`label_components` (canonical = min flat index) once
    converged.
    """
    h, w = mask.shape
    big = h * w
    idx = jnp.arange(big, dtype=jnp.int32).reshape(h, w)
    lab = jnp.where(mask, idx, big)
    if init_labels is not None:
        lab = jnp.where(mask & (init_labels < big), jnp.minimum(lab, init_labels), lab)

    def body(_, lab2d):
        return run_reduce(run_reduce(lab2d, mask, big, axis=1), mask, big,
                          axis=0)

    return jax.lax.fori_loop(0, num_iters, body, lab)


def propagate_min_keys(
    keys: jnp.ndarray,
    mask: jnp.ndarray,
    big: int,
    num_rolls: int = 12,
    num_jumps: int = 1,
    edges_safe: bool = False,
) -> jnp.ndarray:
    """Component-wise minimum of per-pixel int32 keys, roll-based.

    keys/mask: [..., H, W] (leading batch dims allowed).  Background pixels
    hold ``big``.  Propagation is K iterations of 4-neighbour min via
    jnp.roll — pure elementwise vector ops that XLA fuses into one loop
    body, with no scatter or gather and no per-iteration edge-index
    guards.  Each round then pointer-jumps (one gather) using
    the key's low bits as a flat pixel index, squaring the effective
    propagation radius.

    Edge handling: jnp.roll wraps around, so opposite image borders would
    leak into each other.  Pass ``edges_safe=True`` when the caller
    guarantees the border row/column of ``mask`` is False (e.g. the MSER
    sweep pads frames with intensity 255); otherwise a 1-pixel background
    ring is added internally and stripped at the end.

    Keys must embed the pixel index in their low bits (key % (H*W) == flat
    index of some component member whose key is <= every member's) for the
    jump step to be meaningful; pass num_jumps=0 for plain roll propagation.
    """
    if not edges_safe:
        pad_cfg = [(0, 0)] * (mask.ndim - 2) + [(1, 1), (1, 1)]
        mask_p = jnp.pad(mask, pad_cfg, constant_values=False)
        # keys are re-derived below positionally only through mask/min ops,
        # but the jump step needs index consistency — recompute on the
        # padded lattice by shifting the embedded index is NOT possible
        # generically, so disable jumps in the padded fallback.
        keys_p = jnp.pad(keys, pad_cfg, constant_values=big)
        out = propagate_min_keys(
            keys_p, mask_p, big, num_rolls=num_rolls, num_jumps=0,
            edges_safe=True,
        )
        sl = (slice(None),) * (mask.ndim - 2) + (slice(1, -1), slice(1, -1))
        return out[sl]

    bigv = jnp.int32(big)
    k = jnp.where(mask, keys, bigv)

    def roll_min(x):
        m = jnp.minimum(
            jnp.minimum(jnp.roll(x, 1, axis=-2), jnp.roll(x, -1, axis=-2)),
            jnp.minimum(jnp.roll(x, 1, axis=-1), jnp.roll(x, -1, axis=-1)),
        )
        return jnp.where(mask, jnp.minimum(x, m), bigv)

    h, w = mask.shape[-2], mask.shape[-1]
    hw = h * w

    def jump(x):
        flat = x.reshape(x.shape[:-2] + (hw,))
        idx = flat % hw  # anchor pixel index from the key's low bits
        jumped = jnp.take_along_axis(flat, idx, axis=-1)
        out = jnp.where(flat < bigv, jnp.minimum(flat, jumped), bigv)
        return out.reshape(x.shape)

    def body(_, x):
        x = jax.lax.fori_loop(0, num_rolls, lambda i, y: roll_min(y), x)
        for _j in range(num_jumps):
            x = jump(x)
        return x

    # two rounds: rolls seed local minima, jump spreads them, rolls finish
    k = body(0, k)
    k = body(1, k)
    return k


def component_areas(labels: jnp.ndarray, cap: int = 65535) -> jnp.ndarray:
    """Per-pixel component size (uint16, saturating at ``cap``).

    labels: int32 [H, W] with background == H*W.
    """
    h, w = labels.shape
    big = h * w
    flat = labels.reshape(-1)
    counts = jnp.zeros((big + 1,), jnp.int32).at[flat].add(1)
    area = counts[jnp.minimum(flat, big)]
    area = jnp.where(flat < big, area, 0)
    return jnp.minimum(area, cap).astype(jnp.uint16).reshape(h, w)
