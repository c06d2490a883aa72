#!/usr/bin/env python3
"""Decompose the CNN detector's device time: ingest, stem, trunk, heads,
decode.

    python scripts/cnn_profile.py [--batch 128] [--size 1080p|gtsdb]
                                  [--layout bgr|patches8]

Times, each jitted, warmed and ended in ``block_until_ready``: the full
detect (forward + decode), the forward alone, the decode alone, and the
forward truncated after the stem and after the trunk, so each layer's time
is a difference of prefixes.  Prints achieved TFLOP/s from the v3 FLOP
count (a rate, not a share of any peak) beside the card's name and power
limit.  Frames are seeded synthetic scenes (``data/synthetic.py``).
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from traffic_sign_detector.models import cnn_detector as cd


def timeit(fn, *args, iters=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def v3_flops(b: int, h: int, w: int) -> int:
    """Multiply-add FLOPs of one forward: stem K=192 matmul at s8, the
    three 3x3 trunk convs (first one strided to s16) and the heads."""
    s8, s16 = (h // 8) * (w // 8), (h // 16) * (w // 16)
    stem = s8 * 192 * 64
    trunk = s16 * 9 * (64 * 128 + 128 * 128 * 2)
    heads = s16 * 9 * 128 * (cd.NUM_CLASSES + 2 + 2)
    return 2 * b * (stem + trunk + heads)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return jax.devices()[0].device_kind


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", default="1080p", choices=["1080p", "gtsdb"])
    ap.add_argument("--layout", default="patches8",
                    choices=["bgr", "patches8"])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    from traffic_sign_detector.data.synthetic import (
        synth_frames,
        to_patches8,
    )
    from traffic_sign_detector.utils.compile_cache import (
        CHECKOUT,
        enable_compile_cache,
    )

    enable_compile_cache()
    h, w = (1088, 1920) if args.size == "1080p" else (800, 1360)
    b = args.batch
    det = cd.CNNDetector.load(
        os.path.join(CHECKOUT, "artifacts", "cnn_detector", "params.npz"))
    cfg, params = det.cfg, det.params
    dt = cfg.compute_dtype()
    frames = synth_frames(b, seed=0, hw=(h, w))
    if args.layout == "patches8":
        frames = to_patches8(frames)
    frames = jnp.asarray(frames)
    it = args.iters

    def stem(p, x):
        return cd.stem_forward(p["Conv_0"], x, dt)

    def trunk(p, x):
        x = stem(p, x)
        for name, _, _, stride in cd._TRUNK:
            x = jax.nn.relu(cd._conv(p[name], x, stride, dt))
        return x

    fwd = jax.jit(lambda p, x: cd.forward(p, x, dt))
    t_full = timeit(det.dispatch, frames, iters=it)
    t_fwd = timeit(fwd, params, frames, iters=it)
    t_stem = timeit(jax.jit(stem), params, frames, iters=it)
    t_trunk = timeit(jax.jit(trunk), params, frames, iters=it)
    maps = fwd(params, frames)
    t_dec = timeit(jax.jit(lambda m: cd.decode_detections(
        m, cfg.max_detections, cfg.score_threshold, cfg.stride)), maps,
        iters=it)
    flops = v3_flops(b, h, w)

    print(f"card: {card()}")
    print(f"size={args.size} batch={b} layout={args.layout}")
    print(f"full (fwd+decode): {t_full * 1e3:9.3f} ms  "
          f"{b / t_full:9.1f} frames/s")
    print(f"forward only:      {t_fwd * 1e3:9.3f} ms  "
          f"{flops / t_fwd / 1e12:6.1f} TFLOP/s achieved "
          f"({flops / 1e9:.1f} GFLOP)")
    print(f"  stem (+ingest):  {t_stem * 1e3:9.3f} ms")
    print(f"  trunk:           {(t_trunk - t_stem) * 1e3:9.3f} ms")
    print(f"  heads:           {(t_fwd - t_trunk) * 1e3:9.3f} ms")
    print(f"decode only:       {t_dec * 1e3:9.3f} ms")


if __name__ == "__main__":
    main()
