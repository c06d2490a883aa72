"""Convolutional center-point sign detector — the framework's flagship path.

The reference detects signs with a region-proposal pipeline (MSER sweep +
mask correlation, ``Deteción de Objetos/source.py:96-180``).  This module
is the dense-compute answer to the same task: an anchor-free center-point
detector (CenterNet-style) whose compute is almost entirely bf16
convolutions and matmuls, trained on the same gt.txt supervision the
reference's trainer consumes and emitting the same six super-types into
the same resultado.txt protocol.

Design notes:

* An 8x8-stride-8 patchify stem turns the 3-channel input into a K=192
  matmul, so the first layer already has a deep contraction (3-channel
  convs leave most of a matrix unit idle); a 128-wide stride-16 trunk
  follows, with heads on the stride-16 grid.
* The whole network is static-shape; full frames (1360x800, 1920x1088) are
  multiples of the stride so no dynamic padding exists anywhere.
* Peak extraction (the NMS equivalent) is a 3x3 max-pool equality test plus
  one ``top_k`` — no data-dependent control flow, jit-compatible end to end.
* Params are float32, activations bfloat16; the forward is plain JAX over
  the parameter dict (``{"Conv_i": {"kernel", "bias"}}``, HWIO kernels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..data.gt import GroundTruthBox

# Output stride of the decode heads: a 16 px sign spans one cell; sub-cell
# offsets carry the center precision.
STRIDE = 16
NUM_CLASSES = 6  # six super-types; background is "no peak", not a channel
ARCH = "v3"      # the one architecture; checkpoints carry it as __arch__
PATCH = 8        # stem patch side (k = ky*24 + kx*3 + c, HWIO flat order)
STEM_K = PATCH * PATCH * 3
# (name, output channels, kernel side, stride) after the patchify stem
_TRUNK = (("Conv_1", 128, 3, 2), ("Conv_2", 128, 3, 1),
          ("Conv_3", 128, 3, 1))
_HEADS = (("hm", "Conv_4", NUM_CLASSES), ("size", "Conv_5", 2),
          ("off", "Conv_6", 2))
_HM_PRIOR_BIAS = -4.59  # sigmoid(-4.59) ~ 0.01 at initialization


@dataclass(frozen=True)
class CNNDetectorConfig:
    """Decode hyper-parameters + compute dtype (defaults = shipped model)."""

    arch: str = ARCH
    max_detections: int = 32
    # Operating point; the shipped checkpoint tags 0.35 (its F1-optimal
    # band is 0.35-0.45 — PARITY.md round-4 sweep).  Lower toward 0.2 for
    # AP-max, raise for precision.
    score_threshold: float = 0.50
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.arch != ARCH:
            raise ValueError(f"unsupported CNN arch {self.arch!r}: only "
                             f"{ARCH!r} checkpoints can be loaded")

    def compute_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def stride(self) -> int:
        """Output grid stride of the decode heads."""
        return STRIDE


def patchify(x: jax.Array, p: int = PATCH) -> jax.Array:
    """[B, H, W, 3] -> [B, H/p, W/p, p*p*3] (k = ky*p*3 + kx*3 + c): a
    reshape + p-slice concat, the flattened HWIO order of the stem kernel."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h // p, p, w // p, p * c)
    return jnp.concatenate([xs[:, :, r] for r in range(p)], axis=-1)


def stem_forward(stem: dict, x: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """The 8x8-stride-8 stem as patchify + one K=192 matmul.

    Same math as a ``conv(8x8, stride 8)`` with kernel [8, 8, 3, F] + bias
    [F] on ``x/255 - 0.5``.  Inputs are uint8 frames [B, H, W, 3]
    (patchified in-graph) or the ``patches8`` layout [B, H/8, W/8, 192]
    the native loader emits at decode time.
    """
    kernel, bias = stem["kernel"], stem["bias"]
    f = kernel.shape[-1]
    if x.shape[-1] != STEM_K:
        x = patchify(x)
    x = x.astype(dtype) * jnp.asarray(1 / 255.0, dtype) - jnp.asarray(0.5,
                                                                      dtype)
    out = jnp.einsum("bhwk,kf->bhwf", x,
                     kernel.reshape(STEM_K, f).astype(dtype))
    return jax.nn.relu(out + bias.astype(dtype))


def _conv(layer: dict, x: jax.Array, stride: int, dtype) -> jax.Array:
    """SAME-padded NHWC/HWIO conv + bias, operands and result in ``dtype``."""
    y = lax.conv_general_dilated(
        x.astype(dtype), layer["kernel"].astype(dtype), (stride, stride),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + layer["bias"].astype(dtype)


def trunk_heads_forward(params: dict, stem_out: jax.Array,
                        dtype=jnp.bfloat16) -> dict:
    """Conv_1..Conv_6 from stem activations: the trunk (conv + relu) and
    the three head convs, head maps returned in float32.  Shared by the
    plain forward and the fused-upscale path (ops/fused_upscale.py), which
    computes the stem itself."""
    x = stem_out
    for name, _, _, stride in _TRUNK:
        x = jax.nn.relu(_conv(params[name], x, stride, dtype))
    return {key: _conv(params[name], x, 1, dtype).astype(jnp.float32)
            for key, name, _ in _HEADS}


def forward(params: dict, frames_u8: jax.Array, dtype=jnp.bfloat16) -> dict:
    """Anchor-free center detector over the six GTSDB super-types.

    Input: uint8 BGR frames [B, H, W, 3] with H, W multiples of 16, or the
    ``patches8`` layout.  Output dict (stride-16 grids, float32):
      ``hm``   [B, H/16, W/16, 6]  per-class center logits
      ``size`` [B, H/16, W/16, 2]  (w, h) in grid units
      ``off``  [B, H/16, W/16, 2]  (dx, dy) sub-cell center offset in [0, 1)

    No norm layers at inference: the trainer uses BatchNorm and folds it
    into the conv kernels/biases at export (models/cnn_train.py:
    fold_v3_batchnorm), so this chain is pure conv/matmul + relu.
    """
    return trunk_heads_forward(
        params, stem_forward(params["Conv_0"], frames_u8, dtype), dtype)


def init_params(seed: int = 0) -> dict:
    """Random parameters in the checkpoint layout: lecun-normal kernels,
    zero biases, and the heatmap prior on the ``hm`` head's bias."""
    shapes = [("Conv_0", (PATCH, PATCH, 3, 64))]
    cin = 64
    for name, cout, k, _ in _TRUNK:
        shapes.append((name, (k, k, cin, cout)))
        cin = cout
    shapes += [(name, (3, 3, cin, cout)) for _, name, cout in _HEADS]
    init = jax.nn.initializers.lecun_normal()
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    params = {}
    for key, (name, shape) in zip(keys, shapes):
        bias = jnp.zeros((shape[-1],), jnp.float32)
        if name == "Conv_4":
            bias = bias + _HM_PRIOR_BIAS
        params[name] = {"bias": bias,
                        "kernel": init(key, shape, jnp.float32)}
    return params


# ---------------------------------------------------------------------------
# Decode: heatmap peaks -> padded box tensors (static shapes, jit-safe)
# ---------------------------------------------------------------------------


def decode_detections(outputs: dict, k: int, score_threshold: float,
                      stride: int = STRIDE):
    """Turn head outputs into top-k boxes per frame.

    Returns (boxes [B,k,4] float32 xyxy pixels, cls [B,k] int32 1..6,
    scores [B,k] float32, valid [B,k] bool).  The 3x3 max-pool equality test
    is the NMS: a cell survives iff it is the local maximum of its class map.
    ``stride`` is the head-grid stride.
    """
    prob = jax.nn.sigmoid(outputs["hm"])              # [B,Hc,Wc,C]
    b, hc, wc, c = prob.shape
    pooled = lax.reduce_window(prob, -jnp.inf, lax.max, (1, 3, 3, 1),
                               (1, 1, 1, 1), "SAME")
    peaks = jnp.where(prob >= pooled, prob, 0.0)
    flat = peaks.reshape(b, hc * wc * c)
    scores, idx = jax.lax.top_k(flat, k)              # [B,k]
    cls = (idx % c).astype(jnp.int32)
    cell = idx // c
    cy = (cell // wc).astype(jnp.float32)
    cx = (cell % wc).astype(jnp.float32)

    def _gather_map(m):                                # m [B,Hc,Wc,2]
        flat_m = m.reshape(b, hc * wc, 2)
        return jnp.take_along_axis(flat_m, cell[:, :, None], axis=1)

    wh = jnp.maximum(_gather_map(outputs["size"]), 0.0)   # grid units
    off = jnp.clip(_gather_map(outputs["off"]), 0.0, 1.0)
    pcx = (cx + off[..., 0]) * stride
    pcy = (cy + off[..., 1]) * stride
    pw = wh[..., 0] * stride
    ph = wh[..., 1] * stride
    boxes = jnp.stack(
        [pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], axis=-1)
    valid = (scores >= score_threshold) & (pw > 2) & (ph > 2)
    return boxes, cls + 1, scores, valid


# ---------------------------------------------------------------------------
# Parameter persistence (plain npz — no orbax dependency in the product path)
# ---------------------------------------------------------------------------


def save_params(path: str, params, arch: str | None = None,
                score_threshold: float | None = None) -> None:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}
    if arch is not None:
        # arch + operating-point metadata ride in the npz so loaders never
        # need an arch flag
        arrays["__arch__"] = np.asarray(arch)
    if score_threshold is not None:
        arrays["__threshold__"] = np.asarray(score_threshold, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def saved_meta(path: str) -> dict:
    """Read the metadata tags stored in a checkpoint (may be empty)."""
    meta: dict = {}
    with np.load(path) as data:
        if "__arch__" in data.files:
            meta["arch"] = str(data["__arch__"])
        if "__threshold__" in data.files:
            meta["score_threshold"] = float(data["__threshold__"])
    return meta


def saved_arch(path: str) -> str | None:
    """Read the arch tag stored in a checkpoint, if present."""
    return saved_meta(path).get("arch")


def load_params(path: str, template):
    data = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for kp, tmpl in flat:
        key = jax.tree_util.keystr(kp)
        if key not in data:
            raise ValueError(f"checkpoint {path} is missing parameter {key}")
        arr = data[key]
        if arr.shape != tmpl.shape:
            raise ValueError(
                f"checkpoint {path} parameter {key} has shape {arr.shape}, "
                f"model expects {tmpl.shape}")
        leaves.append(jnp.asarray(arr, tmpl.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Full-frame inference driver (product path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 3, 4))
def _detect_jit(cfg: CNNDetectorConfig, params, frames_u8, k, thresh):
    out = forward(params, frames_u8, cfg.compute_dtype())
    return decode_detections(out, k, thresh, cfg.stride)


def upscale_frames(frames_u8: jax.Array, th: int, tw: int) -> jax.Array:
    """On-device bilinear upscale to (th, tw), u8 -> u8.

    Same formulation as the measured 1080p quality protocol
    (scripts/cnn_threshold_sweep.py --input_scale 1080p): float32
    bilinear, round, clip — computed via the phase-sliced 2-tap passes in
    ops/upscale.py (±1 count vs jax.image.resize, measured
    quality-neutral; dense f32 fallback for degenerate ratios) so the
    resize is a banded 2-tap pass instead of a dense interpolation matmul.
    """
    from ..ops.upscale import upscale_bilinear_u8

    return upscale_bilinear_u8(frames_u8, th, tw)


def rescale_boxes(boxes: jax.Array, sx: float, sy: float) -> jax.Array:
    """Map decoded xyxy boxes from the upscaled grid back to native pixels."""
    return boxes / jnp.asarray([sx, sy, sx, sy], jnp.float32)


def upscaled_hw(h: int, w: int, scale: float, stride: int = 16
                ) -> tuple[int, int]:
    """Target dims for upscaled inference: scale, rounded to the stride."""
    th = max(stride, int(round(h * scale / stride)) * stride)
    tw = max(stride, int(round(w * scale / stride)) * stride)
    return th, tw


@partial(jax.jit, static_argnums=(0, 3, 4, 5, 6))
def _detect_upscaled_jit(cfg: CNNDetectorConfig, params, frames_u8, k,
                         thresh, th, tw):
    """Upscaled-inference detect: resize on device, run the forward on the
    scaled frames, and map the boxes back to native coordinates — all in
    ONE jit so the resize fuses with the stem's layout work.

    Small GTSDB signs (16 px spans one s16 cell) recover the quality the
    v3 grid gives up at native resolution: measured on the 150-frame
    protocol, native F1 0.81 / AP 0.853 vs 1.412x-upscaled **0.84 /
    0.942** (PARITY.md round 4)."""
    h, w = frames_u8.shape[1:3]
    out = forward(params, upscale_frames(frames_u8, th, tw),
                  cfg.compute_dtype())
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    return rescale_boxes(boxes, tw / w, th / h), cls, scores, valid


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _detect_fused_upscaled_jit(cfg: CNNDetectorConfig, params, frames_u8,
                               k, thresh, plan):
    """Upscaled inference with NO upscaled frame: the bilinear upscale,
    the 8x8 patchify, and the stem matmul evaluated as one folded linear
    map on native pixels (ops/fused_upscale.py), then the ordinary v3
    trunk/heads/decode at the upscaled grid with boxes mapped back to
    native coordinates.  Replaces the materialize-then-forward
    ``_detect_upscaled_jit`` for fusable rational scales — measured
    section in PARITY.md round 5."""
    from ..ops.fused_upscale import fused_upscale_stem

    stem = fused_upscale_stem(
        frames_u8, params["Conv_0"]["kernel"], params["Conv_0"]["bias"],
        plan, cfg.compute_dtype())
    out = trunk_heads_forward(params, stem, cfg.compute_dtype())
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    sx, sy = plan.rescale_factors()
    return rescale_boxes(boxes, sx, sy), cls, scores, valid


@partial(jax.jit, static_argnums=(0, 5, 6, 7))
def _detect_fused_upscaled_yuv_jit(cfg: CNNDetectorConfig, params, y, cb,
                                   cr, k, thresh, plan):
    """Half-bandwidth ingest + folded upscale: raw 4:2:0 planes ->
    libjpeg-exact BGR (in-graph, ops/yuv.py) -> fused upscale+stem ->
    trunk -> boxes in native coordinates."""
    from ..ops.fused_upscale import fused_upscale_stem
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    stem = fused_upscale_stem(
        frames_u8, params["Conv_0"]["kernel"], params["Conv_0"]["bias"],
        plan, cfg.compute_dtype())
    out = trunk_heads_forward(params, stem, cfg.compute_dtype())
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    sx, sy = plan.rescale_factors()
    return rescale_boxes(boxes, sx, sy), cls, scores, valid


@partial(jax.jit, static_argnums=(0, 5, 6))
def _detect_yuv_patches_jit(cfg: CNNDetectorConfig, params, y_p, cb_p, cr_p,
                            k, thresh):
    """Half-bandwidth ingest with ZERO on-device relayout: patchified raw
    4:2:0 planes in (the layout the native loader emits at decode time),
    converted to BGR patches8 entirely in patch space (ops/yuv.py:
    yuv420_patches_to_bgr_patches8, bit-exact libjpeg math) and consumed
    by the stem as one K=192 matmul, with no in-graph patchify."""
    from ..ops.yuv import yuv420_patches_to_bgr_patches8

    patches = yuv420_patches_to_bgr_patches8(y_p, cb_p, cr_p)
    out = forward(params, patches, cfg.compute_dtype())
    return decode_detections(out, k, thresh, cfg.stride)


@partial(jax.jit, static_argnums=(0, 5, 6))
def _detect_yuv_jit(cfg: CNNDetectorConfig, params, y, cb, cr, k, thresh):
    """Half-bandwidth ingest: raw JPEG 4:2:0 planes in, detections out.

    The host ships 1.5 bytes/px (runtime/loader.py: decode_jpeg_yuv420_batch)
    and the libjpeg-exact upsample + YCbCr->BGR (ops/yuv.py) fuses into the
    same jit as the forward pass, so the conversion runs where the
    bandwidth is free (HBM) instead of where it is scarce (the
    host->device link)."""
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    out = forward(params, frames_u8, cfg.compute_dtype())
    return decode_detections(out, k, thresh, cfg.stride)


@partial(jax.jit, static_argnums=(0, 5, 6, 7, 8))
def _detect_yuv_upscaled_jit(cfg: CNNDetectorConfig, params, y, cb, cr,
                             k, thresh, th, tw):
    """Half-bandwidth ingest + upscaled inference in one jit: raw 4:2:0
    planes -> libjpeg-exact BGR -> bilinear upscale -> forward -> boxes
    mapped back to native coordinates."""
    from ..ops.yuv import yuv420_to_bgr

    frames_u8 = yuv420_to_bgr(y, cb, cr)
    h, w = frames_u8.shape[1:3]
    out = forward(params, upscale_frames(frames_u8, th, tw),
                  cfg.compute_dtype())
    boxes, cls, scores, valid = decode_detections(out, k, thresh, cfg.stride)
    return rescale_boxes(boxes, tw / w, th / h), cls, scores, valid


class CNNDetector:
    """Batched full-frame detector over saved weights.

    Mirrors ``models/detector.py``'s dispatch/collect contract so the
    directory driver and the streaming server can host either model family.
    """

    def __init__(self, params, cfg: CNNDetectorConfig | None = None,
                 upscale: float = 1.0):
        self.cfg = cfg or CNNDetectorConfig()
        self.params = params
        # Upscaled-inference operating point (``--upscale``): frames are
        # bilinearly scaled on device by this factor before the forward and
        # boxes mapped back to native coordinates — recovers the small-sign
        # quality the s16 grid gives up at native GTSDB resolution
        # (F1 0.81 -> 0.83, AP 0.852 -> 0.904+ measured at 1.412x).
        # For fusable rational scales the upscale folds into the stem
        # (ops/fused_upscale.py): the upscaled frame is never materialized.
        self.upscale = float(upscale)

    def _fused_plan(self, h: int, w: int):
        """Fused upscale+stem plan for this operating point, or None."""
        if self.upscale == 1.0:
            return None
        from ..ops.fused_upscale import find_plan

        return find_plan(h, w, self.upscale)

    @classmethod
    def load(cls, path: str, cfg: CNNDetectorConfig | None = None):
        if cfg is None:
            cfg = CNNDetectorConfig(**saved_meta(path))
        template = init_params()
        return cls(load_params(path, template), cfg)

    def save(self, path: str) -> None:
        save_params(path, self.params, arch=self.cfg.arch,
                    score_threshold=self.cfg.score_threshold)

    def dispatch(self, frames: np.ndarray):
        """frames uint8 [B,H,W,3] BGR with H,W multiples of 16."""
        if self.upscale != 1.0:
            if frames.shape[-1] != 3:
                raise ValueError(
                    "upscaled inference needs [B,H,W,3] frames; the "
                    "patches8 layout is pre-patchified at native "
                    "resolution (use --input_format bgr or yuv420)")
            plan = self._fused_plan(frames.shape[1], frames.shape[2])
            if plan is not None:
                return _detect_fused_upscaled_jit(
                    self.cfg, self.params, jnp.asarray(frames),
                    self.cfg.max_detections, self.cfg.score_threshold, plan)
            th, tw = upscaled_hw(frames.shape[1], frames.shape[2],
                                 self.upscale, self.cfg.stride)
            return _detect_upscaled_jit(
                self.cfg, self.params, jnp.asarray(frames),
                self.cfg.max_detections, self.cfg.score_threshold, th, tw)
        return _detect_jit(self.cfg, self.params, jnp.asarray(frames),
                           self.cfg.max_detections, self.cfg.score_threshold)

    def dispatch_yuv(self, y, cb, cr):
        """Raw 4:2:0 planes — the half-bandwidth input path; conversion
        fuses into the forward jit.  Two layouts, keyed on ndim:

        * tight planes: y [B,H,W], cb/cr [B,H/2,W/2] uint8;
        * patchified planes (v3, native-resolution): y [B,H/8,W/8,64],
          cb/cr [B,H/8,W/8,16] — zero on-device relayout (the conversion
          runs in patch space; ops/yuv.py)."""
        if y.ndim == 4 and self.upscale == 1.0:
            return _detect_yuv_patches_jit(
                self.cfg, self.params, jnp.asarray(y), jnp.asarray(cb),
                jnp.asarray(cr), self.cfg.max_detections,
                self.cfg.score_threshold)
        if y.ndim == 4:
            raise ValueError(
                "patchified yuv planes need native resolution (use tight "
                "planes for --upscale)")
        if self.upscale != 1.0:
            plan = self._fused_plan(y.shape[1], y.shape[2])
            if plan is not None:
                return _detect_fused_upscaled_yuv_jit(
                    self.cfg, self.params, jnp.asarray(y), jnp.asarray(cb),
                    jnp.asarray(cr), self.cfg.max_detections,
                    self.cfg.score_threshold, plan)
            th, tw = upscaled_hw(y.shape[1], y.shape[2], self.upscale,
                                 self.cfg.stride)
            return _detect_yuv_upscaled_jit(
                self.cfg, self.params, jnp.asarray(y), jnp.asarray(cb),
                jnp.asarray(cr), self.cfg.max_detections,
                self.cfg.score_threshold, th, tw)
        return _detect_yuv_jit(self.cfg, self.params, jnp.asarray(y),
                               jnp.asarray(cb), jnp.asarray(cr),
                               self.cfg.max_detections,
                               self.cfg.score_threshold)

    def collect(self, handles, filenames: list[str],
                orig_hw: tuple[int, int] | None = None) -> list[GroundTruthBox]:
        boxes, cls, scores, valid = [np.asarray(h) for h in handles]
        dets: list[GroundTruthBox] = []
        for i, name in enumerate(filenames):
            for j in range(boxes.shape[1]):
                if not valid[i, j]:
                    continue
                x1, y1, x2, y2 = boxes[i, j]
                if orig_hw is not None:
                    h, w = orig_hw
                    x1, x2 = np.clip([x1, x2], 0, w - 1)
                    y1, y2 = np.clip([y1, y2], 0, h - 1)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue
                dets.append(GroundTruthBox(
                    filename=name,
                    x1=int(round(float(x1))), y1=int(round(float(y1))),
                    x2=int(round(float(x2))), y2=int(round(float(y2))),
                    class_id=int(cls[i, j]),
                    score=float(scores[i, j])))
        return dets

    def detect_frames(self, frames: np.ndarray, filenames: list[str],
                      orig_hw: tuple[int, int] | None = None):
        return self.collect(self.dispatch(frames), filenames, orig_hw)

    def run_directory(self, directory: str, batch_size: int = 32,
                      progress: bool = False,
                      input_format: str = "bgr") -> list[GroundTruthBox]:
        """Detect over a dataset directory with decode-ahead + one batch in
        flight (same overlap contract as ``DetectionPipeline.run_directory``).

        ``input_format="yuv420"`` ships raw JPEG chroma-subsampled planes
        (1.5 bytes/px) and converts on device — halves the host->device
        upload.
        4:4:4 sources are chroma-pooled by the loader (GTSDB ships 4:4:4;
        measured flagship delta: F1 unchanged at 0.81, AP 0.852 -> 0.839
        — PARITY.md round-4 input-feed note).

        ``input_format="patches8"`` decodes straight into the stem's
        matmul layout [B, H/8, W/8, 192] — same bytes, zero on-device
        relayout."""
        from ..data.images import list_frame_files
        from ..data.prefetch import batched_frames

        if input_format == "yuv420" and self.upscale == 1.0:
            # same bytes, same bit-exact result, zero on-device relayout:
            # prefer the patchified plane layout (falls back transparently)
            input_format = "yuv420p"
        files = list_frame_files(directory)
        dets: list[GroundTruthBox] = []
        pending = None
        done = 0
        orig_hw = None
        for frames, names in batched_frames(directory, files, batch_size,
                                            device_put=True,
                                            input_format=input_format):
            if isinstance(frames, tuple):
                if orig_hw is None:
                    scale = 8 if frames[0].ndim == 4 else 1
                    orig_hw = (int(frames[0].shape[1]) * scale,
                               int(frames[0].shape[2]) * scale)
                out = self.dispatch_yuv(*frames)
            else:
                if orig_hw is None:
                    scale = 8 if frames.shape[-1] == 192 else 1
                    orig_hw = (int(frames.shape[1]) * scale,
                               int(frames.shape[2]) * scale)
                out = self.dispatch(frames)
            if pending is not None:
                dets.extend(d for d in self.collect(*pending)
                            if d.filename != "__pad__")
                done = min(done + batch_size, len(files))
                if progress:
                    print(f"  processed {done}/{len(files)} frames")
            pending = (out, names, orig_hw)
        if pending is not None:
            dets.extend(d for d in self.collect(*pending)
                        if d.filename != "__pad__")
            if progress:
                print(f"  processed {len(files)}/{len(files)} frames")
        return dets
