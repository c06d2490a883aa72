#!/usr/bin/env python3
"""Probe: int8 vs bf16 for the v3 trunk's hot layer on this device.

    python scripts/int8_probe.py

Times the trunk's 3x3 128->128 conv at batch 128 on the 1080p s16 grid
(68x120) in bf16 (XLA's conv) and in int8 as the serving chain runs it
(``cnn_quant.conv_s8``: one s8 x s8 -> s32 GEMM, with and without the
relu/requant epilogue), plus a 4096^3 matmul in each type for the raw
rate.  Every window ends in ``block_until_ready``; the card's name and
power limit print first.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from traffic_sign_detector.models.cnn_quant import conv_s8

B, H, W, C = 128, 68, 120, 128
rng = np.random.default_rng(0)


def timeit(f, *args, iters=20):
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or jax.devices()[0].device_kind}")
    x_f = jnp.asarray(rng.standard_normal((B, H, W, C)), jnp.bfloat16)
    k_f = jnp.asarray(rng.standard_normal((3, 3, C, C)), jnp.bfloat16)
    x_i = jnp.asarray(rng.integers(0, 127, (B, H, W, C)), jnp.int8)
    k_i = jnp.asarray(rng.integers(-127, 127, (3, 3, C, C)), jnp.int8)
    scale = jnp.float32(0.02)

    conv_bf16 = jax.jit(lambda x, k: lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    conv_int8 = jax.jit(lambda x, k: conv_s8(x, k, 1))

    @jax.jit
    def conv_int8_requant(x, k):
        y = jnp.maximum(conv_s8(x, k, 1), 0)
        q = jnp.clip(jnp.round(y.astype(jnp.float32) * scale), 0, 127)
        return q.astype(jnp.int8)

    flop = 2 * B * H * W * C * C * 9
    for name, f, a in (("conv bf16", conv_bf16, (x_f, k_f)),
                       ("conv int8 (s8 GEMM)", conv_int8, (x_i, k_i)),
                       ("conv int8 + requant", conv_int8_requant,
                        (x_i, k_i))):
        t = timeit(f, *a)
        print(f"{name:22s} {t * 1e3:8.3f} ms  {flop / t / 1e12:7.1f} T(FL)OP/s")

    n = 4096
    a_f = jnp.asarray(rng.standard_normal((n, n)), jnp.bfloat16)
    a_i = jnp.asarray(rng.integers(-127, 127, (n, n)), jnp.int8)
    mm_f = jax.jit(lambda a, b: a @ b)
    mm_i = jax.jit(lambda a, b: lax.dot(a, b,
                                        preferred_element_type=jnp.int32))
    flop = 2 * n ** 3
    for name, f, a in (("matmul bf16", mm_f, a_f), ("matmul int8", mm_i,
                                                     a_i)):
        t = timeit(f, a, a)
        print(f"{name:22s} {t * 1e3:8.3f} ms  {flop / t / 1e12:7.1f} T(FL)OP/s")


if __name__ == "__main__":
    main()
