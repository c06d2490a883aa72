"""Seeded synthetic road scenes with planted traffic signs.

Frames for the smoke check and the profiling scripts when the GTSDB frames
are not in the checkout: a vertical gray gradient with 4x4-blocky noise and
6-9 sign-like shapes per frame in the six super-type colours and shapes
(``constants.SIGN_TYPES``), plus the ingest layouts the loader emits
(``patches8``, 4:2:0 planes).
"""

from __future__ import annotations

import numpy as np

RED, BLUE, WHITE, BLACK = (30, 30, 200), (190, 90, 20), (235, 235, 235), \
    (20, 20, 20)


def _draw_sign(img: np.ndarray, kind: int, cy: int, cx: int, r: int) -> None:
    """Plant one sign of super-type ``kind`` (1..6) centred at (cy, cx)."""
    y0, x0 = cy - r, cx - r
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
    d = np.hypot(yy, xx)
    patch = img[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1]
    ring = max(2, r // 5)
    if kind in (1, 3, 4):          # prohibition / stop / no entry: discs
        disc = d <= r
        patch[disc] = RED
        if kind == 1:
            patch[d <= r - ring] = WHITE
            patch[(np.abs(xx) < r / 3) & (np.abs(yy) < r / 2)] = BLACK
        else:
            patch[(np.abs(yy) < r / 5) & (np.abs(xx) < 0.65 * r)] = WHITE
    elif kind in (2, 5):           # danger / yield: triangles
        up = kind == 2
        t = (yy + r) / (2 * r) if up else (r - yy) / (2 * r)
        tri = np.abs(xx) <= t * r
        patch[tri] = RED
        inner = np.abs(xx) <= t * r - 1.8 * ring
        inner &= (t > 0.3) & (t < 0.93)
        patch[inner] = WHITE
    else:                          # mandatory: blue disc with a white arrow
        patch[d <= r] = BLUE
        patch[(np.abs(xx) < r / 6) & (np.abs(yy) < 0.6 * r)] = WHITE


def synth_frames(n: int, seed: int,
                 hw: tuple[int, int] = (800, 1360)) -> np.ndarray:
    """[n, H, W, 3] uint8 BGR road-like scenes, 6-9 signs each (H and W
    multiples of 4)."""
    H, W = hw
    rng = np.random.default_rng(seed)
    rows = np.linspace(140, 80, H, dtype=np.float32)[:, None, None]
    base = np.broadcast_to(rows, (H, W, 3)).astype(np.uint8)
    frames = np.empty((n, H, W, 3), np.uint8)
    for i in range(n):
        noise = rng.integers(0, 24, (H // 4, W // 4, 3), np.uint8)
        frames[i] = base + np.repeat(np.repeat(noise, 4, 0), 4, 1)
        for k in range(int(rng.integers(6, 10))):
            r = int(rng.integers(10, 40))
            cy = int(rng.integers(r + 2, H - r - 2))
            cx = int(rng.integers(r + 2, W - r - 2))
            _draw_sign(frames[i], 1 + k % 6, cy, cx, r)
    return frames


def to_patches8(frames: np.ndarray) -> np.ndarray:
    b, h, w, _ = frames.shape
    return np.ascontiguousarray(
        frames.reshape(b, h // 8, 8, w // 8, 24).transpose(0, 1, 3, 2, 4)
        .reshape(b, h // 8, w // 8, 192))


def to_yuv420(frames: np.ndarray):
    """JFIF BGR -> tight 4:2:0 planes (chroma 2x2-mean pooled)."""
    f = frames.astype(np.float32)
    b_, g_, r_ = f[..., 0], f[..., 1], f[..., 2]
    y = np.clip(np.round(0.299 * r_ + 0.587 * g_ + 0.114 * b_), 0, 255)
    cb = np.clip(np.round(128 - 0.168735892 * r_ - 0.331264108 * g_
                          + 0.5 * b_), 0, 255)
    cr = np.clip(np.round(128 + 0.5 * r_ - 0.418687589 * g_
                          - 0.081312411 * b_), 0, 255)

    def pool(p):
        return ((p[:, 0::2, 0::2] + p[:, 0::2, 1::2] + p[:, 1::2, 0::2]
                 + p[:, 1::2, 1::2] + 2) / 4).astype(np.uint8)

    return y.astype(np.uint8), pool(cb), pool(cr)
