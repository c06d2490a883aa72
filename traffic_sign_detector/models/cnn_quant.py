"""Post-training int8 serving path for the v3 flagship detector.

Why this exists: every activation junction of the int8 chain is written
and re-read at 1 byte instead of 2, so it quantizes the *data movement* as
much as the math: weights are per-output-channel symmetric int8,
activations per-tensor uint7 (post-relu, stored as int8 in [0, 127]), and
every scale/bias fold is applied in the f32 epilogue XLA fuses into the
conv.  Whether it beats the bf16 chain on a given device is measured per
benchmark cell, not assumed.

The quantized chain mirrors ``cnn_detector.forward`` exactly (patchify
stem, three 128-wide trunk convs, three head convs; BatchNorm already
folded at export by ``models/cnn_train.py: fold_v3_batchnorm``):

* **stem** — the float stem computes ``relu((x/255 - 0.5) @ W + b)`` from
  uint8 patches.  With ``xs = x - 128`` (int8), ``x/255 - 0.5 =
  xs/255 + 128/255 - 0.5``, so the whole affine folds into the epilogue:
  ``acc = xs @ Wq`` in int8 with int32 accumulation, then
  ``relu(acc * (sw/255) + [b + (128/255 - 0.5) * colsum(W)])``.
* **trunk conv i** — ``acc = conv_s8(h_{i-1}, Wq_i)``;
  ``relu(acc * (a_{i-1} * sw_i) + b_i)``; requantize by ``1/a_i``.
* **heads** — int8 conv, dequantizing epilogue, f32 outputs (tiny writes).

Calibration needs only a handful of real frames: per-tensor activation
scales are ``percentile(|act|, q) / 127`` with q = **100 (max) by
default** — measured, not assumed: at q = 99.9 the clipped long-tail relu
activations are exactly the cells the detector's center peaks ride on, and
peak probability error explodes (mean |dP| 0.136 vs 0.015 at max
calibration on real test frames; the full-set quality of the shipped
artifact is recorded in PARITY.md next to its bf16 source).

This is a *serving* artifact: training stays bf16; ``scripts/quantize_cnn.py``
converts any v3 checkpoint.  Reference pointer: the reference has no
quantization (pure float OpenCV/sklearn, ``Deteción de Objetos/source.py``);
this is a beyond-parity deployment feature.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cnn_detector import (
    ARCH,
    PATCH,
    STEM_K,
    CNNDetector,
    CNNDetectorConfig,
    decode_detections,
    patchify,
    rescale_boxes,
    upscale_frames,
    upscaled_hw,
)

_TRUNK = (1, 2, 3)          # Conv_1..Conv_3 (stride 2, 1, 1)
_TRUNK_STRIDES = {1: 2, 2: 1, 3: 1}
_HEADS = {4: "hm", 5: "size", 6: "off"}


def _channel_scales(kernel: np.ndarray) -> np.ndarray:
    """Per-output-channel symmetric scales (last axis = out channels)."""
    flat = np.abs(kernel.reshape(-1, kernel.shape[-1]))
    return np.maximum(flat.max(axis=0), 1e-12).astype(np.float32) / 127.0


def _quant_weight(kernel: np.ndarray, scales: np.ndarray) -> np.ndarray:
    q = np.round(kernel / scales)
    return np.clip(q, -127, 127).astype(np.int8)


# ---------------------------------------------------------------------------
# Float v3 forward with exposed activations (calibration only, host-friendly)
# ---------------------------------------------------------------------------


def v3_float_activations(params, frames_u8: jax.Array) -> list[jax.Array]:
    """Post-relu activations [y0, y1, y2, y3] of the float v3 chain in f32.

    The calibration reference: full-f32 products (``Precision.HIGHEST``,
    no TF32), checked against ``cnn_detector.forward`` in
    tests/test_cnn_quant.py.
    """
    hi = lax.Precision.HIGHEST
    x = frames_u8
    if x.shape[-1] != STEM_K:
        x = patchify(x)
    k0 = np.asarray(params["Conv_0"]["kernel"], np.float32)
    b0 = np.asarray(params["Conv_0"]["bias"], np.float32)
    xf = x.astype(jnp.float32) / 255.0 - 0.5
    y = jax.nn.relu(
        jnp.einsum("bhwk,kf->bhwf", xf, jnp.asarray(k0.reshape(STEM_K, -1)),
                   precision=hi)
        + b0)
    acts = [y]
    for i in _TRUNK:
        k = jnp.asarray(params[f"Conv_{i}"]["kernel"], jnp.float32)
        b = jnp.asarray(params[f"Conv_{i}"]["bias"], jnp.float32)
        dn = lax.conv_dimension_numbers(y.shape, k.shape,
                                        ("NHWC", "HWIO", "NHWC"))
        s = _TRUNK_STRIDES[i]
        y = jax.nn.relu(
            lax.conv_general_dilated(y, k, (s, s), "SAME",
                                     dimension_numbers=dn, precision=hi) + b)
        acts.append(y)
    return acts


# ---------------------------------------------------------------------------
# Quantization (host-side, one-shot)
# ---------------------------------------------------------------------------


def quantize_v3(params, calib_frames: np.ndarray,
                percentile: float = 100.0,
                float_heads: bool = False) -> dict:
    """Convert float v3 params -> int8 serving params.

    ``calib_frames`` uint8 [N, H, W, 3] (a handful of real frames; scales
    are per-tensor so any resolution that is a multiple of 16 works).
    Returns a flat dict of numpy arrays ready for ``save_quant_params``:

    * ``q{i}_kernel`` int8 — stem as [192, F], convs as HWIO
    * ``q{i}_mult``  f32 [F] — per-channel epilogue multiplier
      (input_scale * weight_scale), dequantizing ``acc`` to float
    * ``q{i}_bias``  f32 [F] — epilogue bias (stem affine folded in)
    * ``a{i}_inv``   f32 scalar — output requant multiplier (1/act_scale),
      stem + trunk only (head outputs stay f32)
    """
    out: dict[str, np.ndarray] = {}

    # activation scales from the float chain
    acts = v3_float_activations(params, jnp.asarray(calib_frames))
    a_scale = []
    for y in acts:
        hi = float(np.percentile(np.asarray(y), percentile))
        a_scale.append(max(hi, 1e-6) / 127.0)

    # stem: fold the (x/255 - 0.5) input affine of uint8 frames re-centered
    # to int8 by xs = x - 128
    k0 = np.asarray(params["Conv_0"]["kernel"], np.float32).reshape(
        STEM_K, -1)
    b0 = np.asarray(params["Conv_0"]["bias"], np.float32)
    sw0 = _channel_scales(k0)
    out["q0_kernel"] = _quant_weight(k0, sw0)
    out["q0_mult"] = sw0 / 255.0
    out["q0_bias"] = b0 + (128.0 / 255.0 - 0.5) * k0.sum(axis=0)
    out["a0_inv"] = np.float32(1.0 / a_scale[0])

    for i in _TRUNK:
        k = np.asarray(params[f"Conv_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"Conv_{i}"]["bias"], np.float32)
        sw = _channel_scales(k)
        out[f"q{i}_kernel"] = _quant_weight(k, sw)
        out[f"q{i}_mult"] = (a_scale[i - 1] * sw).astype(np.float32)
        out[f"q{i}_bias"] = b
        out[f"a{i}_inv"] = np.float32(1.0 / a_scale[i])

    for i in _HEADS:
        k = np.asarray(params[f"Conv_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"Conv_{i}"]["bias"], np.float32)
        if float_heads:
            # heads keep float weights: the trunk output stays an int8
            # HBM tensor (the bandwidth win), dequantized inline per head
            # conv, removing head weight-quant error from the score path
            out[f"f{i}_kernel"] = k
            out[f"f{i}_bias"] = b
            continue
        sw = _channel_scales(k)
        out[f"q{i}_kernel"] = _quant_weight(k, sw)
        out[f"q{i}_mult"] = (a_scale[3] * sw).astype(np.float32)
        out[f"q{i}_bias"] = b
    if float_heads:
        out["a3_scale"] = np.float32(a_scale[3])
    return out


# ---------------------------------------------------------------------------
# Int8 forward (the serving graph)
# ---------------------------------------------------------------------------


def v3_int8_forward(q: dict, frames_u8: jax.Array) -> dict:
    """Quantized v3 forward: uint8 frames/patches -> f32 head maps.

    Every conv runs s8 x s8 -> s32 with the scale/bias/relu/requant epilogue
    fused by XLA; inter-layer activations live in device memory as int8,
    halving the bytes at every junction.
    """
    x = frames_u8
    if x.shape[-1] != STEM_K:
        x = patchify(x)
    xs = (x.astype(jnp.int32) - 128).astype(jnp.int8)
    acc = jnp.einsum("bhwk,kf->bhwf", xs, q["q0_kernel"],
                     preferred_element_type=jnp.int32)
    y = jnp.maximum(acc.astype(jnp.float32) * q["q0_mult"] + q["q0_bias"],
                    0.0)
    h = jnp.clip(jnp.round(y * q["a0_inv"]), 0, 127).astype(jnp.int8)
    return v3_int8_trunk_heads(q, h)


def conv_s8(h: jax.Array, k: jax.Array, stride: int) -> jax.Array:
    """SAME-padded NHWC int8 conv as ONE s8 x s8 -> s32 matmul.

    The input is unfolded into [B, Ho, Wo, kh*kw*C] patches (tap order
    (dy, dx, c), the flattened HWIO kernel order) and contracted with the
    reshaped kernel.  Bit-identical to ``lax.conv_general_dilated`` with
    ``preferred_element_type=int32`` — integer sums are exact — but it
    lowers on CUDA, where XLA has no s8 -> s32 convolution (it widens the
    operands and cuDNN refuses an s32 conv) while int8 GEMMs are native.
    """
    kh, kw, c, f = k.shape
    b, hh, ww, _ = h.shape
    ho, wo = -(-hh // stride), -(-ww // stride)
    ph = max((ho - 1) * stride + kh - hh, 0)
    pw = max((wo - 1) * stride + kw - ww, 0)
    hp = jnp.pad(h, ((0, 0), (ph // 2, ph - ph // 2),
                     (pw // 2, pw - pw // 2), (0, 0)))
    cols = [hp[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    patches = jnp.concatenate(cols, axis=-1)
    return jnp.einsum("bhwk,kf->bhwf", patches, k.reshape(kh * kw * c, f),
                      preferred_element_type=jnp.int32)


def head_kernel(q: dict) -> tuple[jax.Array, list[int]]:
    """The three int8 head kernels side by side, zero-padded to 16 output
    channels: they read the same trunk output, so they run as ONE int8
    GEMM.  -> (kernel [3, 3, 128, 16], per-head widths)."""
    ks = [q[f"q{i}_kernel"] for i in _HEADS]
    widths = [k.shape[-1] for k in ks]
    pad = jnp.zeros(ks[0].shape[:-1] + (-sum(widths) % 16,), jnp.int8)
    return jnp.concatenate(ks + [pad], axis=-1), widths


def v3_int8_trunk_heads(q: dict, h: jax.Array) -> dict:
    """Conv_1..Conv_6 of the int8 chain from requantized stem activations
    ``h`` (int8 in [0, 127], scale 1/a0_inv) — shared by the plain forward
    and the fused-upscale path, which computes the stem itself."""
    for i in _TRUNK:
        acc = conv_s8(h, q[f"q{i}_kernel"], _TRUNK_STRIDES[i])
        y = jnp.maximum(
            acc.astype(jnp.float32) * q[f"q{i}_mult"] + q[f"q{i}_bias"], 0.0)
        h = jnp.clip(jnp.round(y * q[f"a{i}_inv"]), 0, 127).astype(jnp.int8)

    if "f4_kernel" in q:
        hf = h.astype(jnp.bfloat16) * q["a3_scale"].astype(jnp.bfloat16)
        outs = {}
        for i, name in _HEADS.items():
            k = q[f"f{i}_kernel"].astype(jnp.bfloat16)
            acc = lax.conv_general_dilated(
                hf, k, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            outs[name] = acc.astype(jnp.float32) + q[f"f{i}_bias"]
        return outs
    kcat, widths = head_kernel(q)
    acc = conv_s8(h, kcat, 1).astype(jnp.float32)
    outs, off = {}, 0
    for (i, name), width in zip(_HEADS.items(), widths):
        outs[name] = (acc[..., off:off + width] * q[f"q{i}_mult"]
                      + q[f"q{i}_bias"])
        off += width
    return outs


@partial(jax.jit, static_argnums=(0, 3, 4))
def _detect_int8_jit(cfg: CNNDetectorConfig, q, frames_u8, k, thresh):
    out = v3_int8_forward(q, frames_u8)
    return decode_detections(out, k, thresh, cfg.stride)


@partial(jax.jit, static_argnums=(0, 5, 6))
def _detect_int8_yuv_patches_jit(cfg: CNNDetectorConfig, q, y_p, cb_p, cr_p,
                                 k, thresh):
    """Int8 twin of ``cnn_detector._detect_yuv_patches_jit``: patchified
    raw 4:2:0 planes -> patch-space conversion -> int8 stem matmul."""
    from ..ops.yuv import yuv420_patches_to_bgr_patches8

    patches = yuv420_patches_to_bgr_patches8(y_p, cb_p, cr_p)
    out = v3_int8_forward(q, patches)
    return decode_detections(out, k, thresh, cfg.stride)


@partial(jax.jit, static_argnums=(0, 5, 6))
def _detect_int8_yuv_jit(cfg: CNNDetectorConfig, q, y, cb, cr, k, thresh):
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    out = v3_int8_forward(q, frames_u8)
    return decode_detections(out, k, thresh, cfg.stride)


def _stem_float_from_quant(q: dict) -> tuple[jax.Array, jax.Array]:
    """Reconstruct the float stem (kernel [8, 8, 3, F], bias [F]) from the
    int8 artifact's own stem tensors.

    ``quantize_v3`` stores q0_kernel = round(k0/sw0), q0_mult = sw0/255 and
    q0_bias = b0 + (128/255 - 0.5) * colsum(k0); inverting those recovers
    k0 within the artifact's own stem quantization error.  Used by the
    fused-upscale path, whose stem input is interpolated (non-integer) —
    the int8 stem matmul does not apply, but the trunk (where the int8
    bandwidth win lives) is unchanged.
    """
    k0 = q["q0_kernel"].astype(jnp.float32) * (q["q0_mult"] * 255.0)
    b0 = q["q0_bias"] - np.float32(128.0 / 255.0 - 0.5) * k0.sum(axis=0)
    f = k0.shape[-1]
    return k0.reshape(PATCH, PATCH, 3, f), b0


def _int8_fused_stem_trunk(cfg, q, frames_u8, k, thresh, plan):
    from ..ops.fused_upscale import fused_upscale_stem

    k0, b0 = _stem_float_from_quant(q)
    y0 = fused_upscale_stem(frames_u8, k0, b0, plan, jnp.bfloat16)
    h = jnp.clip(jnp.round(y0.astype(jnp.float32) * q["a0_inv"]),
                 0, 127).astype(jnp.int8)
    out = v3_int8_trunk_heads(q, h)
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    sx, sy = plan.rescale_factors()
    return rescale_boxes(boxes, sx, sy), cls, scores, valid


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _detect_int8_fused_upscaled_jit(cfg: CNNDetectorConfig, q, frames_u8,
                                    k, thresh, plan):
    """Int8 twin of ``cnn_detector._detect_fused_upscaled_jit``: folded
    upscale+patchify+stem in bf16 (stem input is interpolated), requantize,
    int8 trunk/heads, boxes mapped back to native coordinates."""
    return _int8_fused_stem_trunk(cfg, q, frames_u8, k, thresh, plan)


@partial(jax.jit, static_argnums=(0, 5, 6, 7))
def _detect_int8_fused_upscaled_yuv_jit(cfg: CNNDetectorConfig, q, y, cb,
                                        cr, k, thresh, plan):
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    return _int8_fused_stem_trunk(cfg, q, frames_u8, k, thresh, plan)


@partial(jax.jit, static_argnums=(0, 3, 4, 5, 6))
def _detect_int8_upscaled_jit(cfg: CNNDetectorConfig, q, frames_u8, k,
                              thresh, th, tw):
    """Int8 twin of ``cnn_detector._detect_upscaled_jit`` — on-device
    bilinear upscale fused with the int8 forward, boxes mapped back to
    native coordinates."""
    h, w = frames_u8.shape[1:3]
    out = v3_int8_forward(q, upscale_frames(frames_u8, th, tw))
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    return rescale_boxes(boxes, tw / w, th / h), cls, scores, valid


@partial(jax.jit, static_argnums=(0, 5, 6, 7, 8))
def _detect_int8_yuv_upscaled_jit(cfg: CNNDetectorConfig, q, y, cb, cr,
                                  k, thresh, th, tw):
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    h, w = frames_u8.shape[1:3]
    out = v3_int8_forward(q, upscale_frames(frames_u8, th, tw))
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    return rescale_boxes(boxes, tw / w, th / h), cls, scores, valid


# ---------------------------------------------------------------------------
# Persistence + detector class (drop-in for CNNDetector)
# ---------------------------------------------------------------------------


def save_quant_params(path: str, q: dict, arch: str = ARCH,
                      score_threshold: float | None = None,
                      source_sha256: str | None = None) -> None:
    arrays = dict(q)
    arrays["__arch__"] = np.asarray(arch)
    arrays["__quant__"] = np.asarray("int8")
    if score_threshold is not None:
        arrays["__threshold__"] = np.asarray(score_threshold, np.float32)
    if source_sha256 is not None:
        arrays["__source_sha256__"] = np.asarray(source_sha256)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_quant_params(path: str) -> tuple[dict, dict]:
    """-> (q arrays as jnp, meta dict with arch/score_threshold)."""
    meta: dict = {}
    q: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__arch__":
                meta["arch"] = str(data[key])
            elif key == "__threshold__":
                meta["score_threshold"] = float(data[key])
            elif key.startswith("__"):
                continue
            else:
                q[key] = jnp.asarray(data[key])
    return q, meta


def saved_quant(path: str) -> str | None:
    """Quantization tag of a checkpoint ("int8") or None for float ones."""
    with np.load(path) as data:
        if "__quant__" in data.files:
            return str(data["__quant__"])
    return None


class QuantCNNDetector(CNNDetector):
    """Int8 drop-in for ``CNNDetector`` (same dispatch/collect contract,
    so the CLI driver, bench, and the streaming server host it unchanged)."""

    def __init__(self, q: dict, cfg: CNNDetectorConfig | None = None,
                 upscale: float = 1.0):
        self.cfg = cfg or CNNDetectorConfig()
        self.q = q
        self.params = None  # float params intentionally absent
        self.upscale = float(upscale)

    @classmethod
    def load(cls, path: str, cfg: CNNDetectorConfig | None = None):
        q, meta = load_quant_params(path)
        if cfg is None:
            cfg = CNNDetectorConfig(**meta)
        return cls(q, cfg)

    def save(self, path: str) -> None:
        save_quant_params(path, {k: np.asarray(v) for k, v in self.q.items()},
                          arch=self.cfg.arch,
                          score_threshold=self.cfg.score_threshold)

    def dispatch(self, frames):
        if self.upscale != 1.0:
            if frames.shape[-1] != 3:
                raise ValueError(
                    "upscaled inference needs [B,H,W,3] frames; the "
                    "patches8 layout is pre-patchified at native "
                    "resolution (use --input_format bgr or yuv420)")
            plan = self._fused_plan(frames.shape[1], frames.shape[2])
            if plan is not None:
                return _detect_int8_fused_upscaled_jit(
                    self.cfg, self.q, jnp.asarray(frames),
                    self.cfg.max_detections, self.cfg.score_threshold, plan)
            th, tw = upscaled_hw(frames.shape[1], frames.shape[2],
                                 self.upscale, self.cfg.stride)
            return _detect_int8_upscaled_jit(
                self.cfg, self.q, jnp.asarray(frames),
                self.cfg.max_detections, self.cfg.score_threshold, th, tw)
        return _detect_int8_jit(self.cfg, self.q, jnp.asarray(frames),
                                self.cfg.max_detections,
                                self.cfg.score_threshold)

    def dispatch_yuv(self, y, cb, cr):
        if y.ndim == 4 and self.upscale == 1.0:
            return _detect_int8_yuv_patches_jit(
                self.cfg, self.q, jnp.asarray(y), jnp.asarray(cb),
                jnp.asarray(cr), self.cfg.max_detections,
                self.cfg.score_threshold)
        if y.ndim == 4:
            raise ValueError(
                "patchified yuv planes need native resolution (use tight "
                "planes for --upscale)")
        if self.upscale != 1.0:
            plan = self._fused_plan(y.shape[1], y.shape[2])
            if plan is not None:
                return _detect_int8_fused_upscaled_yuv_jit(
                    self.cfg, self.q, jnp.asarray(y), jnp.asarray(cb),
                    jnp.asarray(cr), self.cfg.max_detections,
                    self.cfg.score_threshold, plan)
            th, tw = upscaled_hw(y.shape[1], y.shape[2], self.upscale,
                                 self.cfg.stride)
            return _detect_int8_yuv_upscaled_jit(
                self.cfg, self.q, jnp.asarray(y), jnp.asarray(cb),
                jnp.asarray(cr), self.cfg.max_detections,
                self.cfg.score_threshold, th, tw)
        return _detect_int8_yuv_jit(self.cfg, self.q, jnp.asarray(y),
                                    jnp.asarray(cb), jnp.asarray(cr),
                                    self.cfg.max_detections,
                                    self.cfg.score_threshold)


def load_detector(path: str, cfg: CNNDetectorConfig | None = None,
                  upscale: float = 1.0):
    """Load either a float or an int8 checkpoint by its own metadata."""
    if saved_quant(path) == "int8":
        det = QuantCNNDetector.load(path, cfg)
    else:
        det = CNNDetector.load(path, cfg)
    det.upscale = float(upscale)
    return det
