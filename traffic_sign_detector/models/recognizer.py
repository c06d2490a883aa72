"""Práctica-2 recognition: training-data construction, classifiers, harness.

Pipeline (reference `Reconocimiento de Objetos/source.py:350-482,485-641,
646-809`):

* **positives** — GT boxes cropped from the grayscale train frames, resized
  32x32, grouped by super-type 1..6;
* **negatives (class 0)** — MSER proposals over the train frames (the REC
  detector variant: grow 1.15, 32x32 crops) whose max IoU against any GT box
  of their frame is <= 0.5; proposals are cached to a versioned .npz artifact
  (the replacement of the reference's MSERTrain.val pickle);
* **features** — HOG (324-d) or raw GRAY (1024-d) descriptors, batched;
* **LDABAYES** — six binary LDA heads (each super-type vs. the full negative
  pool) with the reference's arbitration rule; or **KNN** — a 7-class LDA
  reduction followed by 4-NN majority vote;
* **validation harness** — per-class shuffle, 90/10 split, fit, predict,
  confusion matrix + classification report.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ClassifierConfig, MSERConfig
from ..constants import (
    DEDUP_COORD_TOL,
    DEDUP_HIST_TOL,
    NEGATIVE_IOU_MAX,
    RECOG_CROP,
    RECOG_GROW,
    SIGN_NAMES,
)
from ..data.gt import load_ground_truth
from ..data.images import list_frame_files, load_image_bgr
from ..eval.reports import classification_report, confusion_matrix
from ..ops.color import bgr_to_gray
from ..ops.dedup import dedup_by_coords, dedup_by_histogram
from ..ops.geometry import filter_and_grow_boxes, iou_matrix
from ..ops.hog import gray_descriptors, hog_descriptors
from ..ops.mser import mser_regions
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from .knn import KNNParams, knn_fit, knn_predict
from .lda import LDAParams, lda_fit, lda_predict_proba, lda_transform

PROPOSAL_CACHE_VERSION = 1


# ---------------------------------------------------------------------------
# Proposal extraction (the REC-variant detector) + cache artifact
# ---------------------------------------------------------------------------

def _propose_frame(bgr: jnp.ndarray, cfg: MSERConfig,
                   grows: tuple[float, ...] = (RECOG_GROW,)):
    """One frame -> (boxes [N,4] xyxy, crops_gray [N,32,32], valid [N]).

    ``grows``: union of the per-factor grown proposal sets (see
    `config.PipelineConfig.rec_grows`); the reference uses the single
    factor 1.15 (`Reconocimiento de Objetos/source.py:54`).
    """
    gray = enhance_contrast(bgr)
    props, pvalid = mser_regions(gray, cfg)
    per_grow = [filter_and_grow_boxes(props, pvalid, g) for g in grows]
    boxes = jnp.concatenate([b for b, _ in per_grow])
    keep = jnp.concatenate([k for _, k in per_grow])
    crops = crop_and_resize(bgr, boxes, RECOG_CROP)
    crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
    crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
    crops_gray = bgr_to_gray(crops)
    return boxes, crops_gray, keep


@functools.lru_cache(maxsize=8)
def _propose_batch_fn(cfg: MSERConfig, grows: tuple[float, ...]):
    return jax.jit(jax.vmap(lambda f: _propose_frame(f, cfg, grows)))


def extract_train_proposals(
    train_dir: str,
    cfg: MSERConfig,
    cache_path: str | None = None,
    batch_size: int = 8,
    limit: int | None = None,
    grows: tuple[float, ...] = (RECOG_GROW,),
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """MSER proposals for every train frame: {fname: (boxes, gray_crops)}.

    Results are memoized to ``cache_path`` (.npz), the replacement for the
    reference's MSERTrain.val pickle (`Reconocimiento de
    Objetos/source.py:380-398`) — regenerated automatically when absent or
    when the config/version changes.
    """
    files = list_frame_files(train_dir)
    if limit is not None:
        files = files[:limit]
    grow_tag = ",".join(f"{g:g}" for g in grows)
    tag = (f"v{PROPOSAL_CACHE_VERSION}:{cfg.to_string()}:"
           f"ds{cfg.downscale}:g{grow_tag}:{len(files)}")

    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=False)
        if str(z.get("tag")) == tag:
            out = {}
            for f in files:
                key = f.replace(".", "_")
                out[f] = (z[f"boxes_{key}"], z[f"crops_{key}"])
            return out

    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for start in range(0, len(files), batch_size):
        if start and start % (batch_size * 10) == 0:
            print(f"  proposals: {start}/{len(files)} frames", flush=True)
        chunk = files[start : start + batch_size]
        frames = np.stack([load_image_bgr(os.path.join(train_dir, f)) for f in chunk])
        pad = batch_size - len(chunk)
        if pad:
            frames = np.concatenate([frames, frames[-1:].repeat(pad, 0)])
        boxes, crops, valid = _propose_batch_fn(cfg, grows)(jnp.asarray(frames))
        boxes, crops, valid = np.asarray(boxes), np.asarray(crops), np.asarray(valid)
        for i, f in enumerate(chunk):
            v = valid[i]
            out[f] = (boxes[i][v], crops[i][v])

    if cache_path:
        payload = {"tag": np.asarray(tag)}
        for f, (b, c) in out.items():
            key = f.replace(".", "_")
            payload[f"boxes_{key}"] = b
            payload[f"crops_{key}"] = c
        np.savez_compressed(cache_path, **payload)
    return out


def extract_train_proposals_cnn(
    train_dir: str,
    cnn_detector,
    cache_path: str | None = None,
    batch_size: int = 8,
    limit: int | None = None,
    grow: float = RECOG_GROW,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """CNN low-threshold proposals for every train frame (round 4).

    Same contract as `extract_train_proposals` ({fname: (boxes xyxy,
    gray 32x32 crops)}) with the flagship detector as the proposal source:
    mine at the detector's configured (low) ``score_threshold`` so the
    classifier trains on the detector's own candidate distribution —
    including its near-threshold false positives, exactly the negatives it
    must reject at inference.
    """
    from .rec_pipeline import grow_boxes_xyxy

    files = list_frame_files(train_dir)
    if limit is not None:
        files = files[:limit]
    det = cnn_detector
    tag = (f"cnn-v1:{params_digest(det)}:thr{det.cfg.score_threshold:g}:"
           f"k{det.cfg.max_detections}:g{grow:g}:{len(files)}")

    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=False)
        if str(z.get("tag")) == tag:
            out = {}
            for f in files:
                key = f.replace(".", "_")
                out[f] = (z[f"boxes_{key}"], z[f"crops_{key}"])
            return out

    @jax.jit
    def crops_for(frames, boxes, valid):
        hw = (frames.shape[1], frames.shape[2])

        def per_frame(bgr, bxs, pv):
            gb, keep = grow_boxes_xyxy(bxs, pv, grow, hw)
            crops = crop_and_resize(bgr, gb, RECOG_CROP)
            return gb, bgr_to_gray(crops), keep

        return jax.vmap(per_frame)(frames, boxes, valid)

    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for start in range(0, len(files), batch_size):
        if start and start % (batch_size * 10) == 0:
            print(f"  cnn proposals: {start}/{len(files)} frames", flush=True)
        chunk = files[start : start + batch_size]
        frames = np.stack(
            [load_image_bgr(os.path.join(train_dir, f)) for f in chunk])
        pad = batch_size - len(chunk)
        if pad:
            frames = np.concatenate([frames, frames[-1:].repeat(pad, 0)])
        dev = jnp.asarray(frames)
        pboxes, _, _, pvalid = det.dispatch(dev)
        gboxes, gcrops, keep = crops_for(dev, pboxes, pvalid)
        gboxes, gcrops, keep = (np.asarray(gboxes), np.asarray(gcrops),
                                np.asarray(keep))
        for i, f in enumerate(chunk):
            v = keep[i]
            out[f] = (gboxes[i][v], gcrops[i][v])

    if cache_path:
        payload = {"tag": np.asarray(tag)}
        for f, (b, c) in out.items():
            key = f.replace(".", "_")
            payload[f"boxes_{key}"] = b
            payload[f"crops_{key}"] = c
        np.savez_compressed(cache_path, **payload)
    return out


def params_digest(det) -> str:
    """Short content digest of a CNNDetector's parameters (cache keying)."""
    import hashlib

    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(det.params):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:12]


# ---------------------------------------------------------------------------
# Training-set assembly
# ---------------------------------------------------------------------------

def build_training_data(
    train_dir: str,
    gt_path: str | None = None,
    mser_cfg: MSERConfig | None = None,
    cache_path: str | None = None,
    limit: int | None = None,
    seed: int = 0,
    proposal_positives: bool = False,
    grows: tuple[float, ...] = (RECOG_GROW,),
    proposals: dict[str, tuple[np.ndarray, np.ndarray]] | None = None,
) -> dict[int, np.ndarray]:
    """Class-keyed crops {0..6: [M, 32, 32] uint8 gray}, per-class shuffled.

    Class 0 = mined negatives, classes 1..6 = GT positives.

    ``proposals`` overrides the MSER proposal source with a prebuilt
    {fname: (boxes, crops)} dict (e.g. `extract_train_proposals_cnn`).

    ``proposal_positives=True`` additionally labels train-set MSER
    proposals with IoU > 0.5 against a GT box as positives of that box's
    class.  The reference drops these crops entirely
    (`Reconocimiento de Objetos/source.py:415-424` keeps only IoU<=0.5 as
    negatives), so its classifier never sees an inference-style positive —
    grown, mis-centered, context-padded — only pixel-exact GT crops.  That
    train/test distribution gap is the dominant recall limiter measured in
    round 3 (test R 0.18 with a proposal-coverage ceiling of 0.62);
    matching the training distribution to the inference distribution is
    the framework's (non-parity) fix.
    """
    gt_path = gt_path or os.path.join(train_dir, "gt.txt")
    mser_cfg = mser_cfg or MSERConfig()
    gt = load_ground_truth(gt_path, drop_unmapped=True)
    files = set(list_frame_files(train_dir) if limit is None
                else list_frame_files(train_dir)[:limit])
    gt = [g for g in gt if g.filename in files]

    by_frame: dict[str, list] = {}
    for g in gt:
        by_frame.setdefault(g.filename, []).append(g)

    data: dict[int, list[np.ndarray]] = {c: [] for c in range(7)}

    # positives: gray full-frame crops resized 32x32.  Gray conversion on
    # host (the exact cv2 fixed-point formula) and ONE padded device call
    # for all crops instead of a device round trip per frame.
    raw_crops: list[np.ndarray] = []
    crop_classes: list[int] = []
    for fname in sorted(by_frame):
        bgr = load_image_bgr(os.path.join(train_dir, fname)).astype(np.int32)
        gray = (
            (bgr[..., 2] * 9798 + bgr[..., 1] * 19235 + bgr[..., 0] * 3735
             + (1 << 14)) >> 15
        ).astype(np.uint8)
        hh, ww = gray.shape
        for g in by_frame[fname]:
            y1, y2 = max(g.y1, 0), min(max(g.y2, g.y1 + 1), hh)
            x1, x2 = max(g.x1, 0), min(max(g.x2, g.x1 + 1), ww)
            raw_crops.append(gray[y1:y2, x1:x2])
            crop_classes.append(g.class_id)
    if raw_crops:
        hp = -(-max(c.shape[0] for c in raw_crops) // 32) * 32
        wp = -(-max(c.shape[1] for c in raw_crops) // 32) * 32
        buf = np.zeros((len(raw_crops), hp, wp), np.uint8)
        boxes = np.zeros((len(raw_crops), 4), np.int32)
        for i, c in enumerate(raw_crops):
            buf[i, : c.shape[0], : c.shape[1]] = c
            boxes[i] = (0, 0, c.shape[1], c.shape[0])
        resized = np.asarray(
            jax.vmap(
                lambda im, bx: crop_and_resize(im, bx[None], RECOG_CROP)[0]
            )(jnp.asarray(buf), jnp.asarray(boxes))
        )
        for cls, crop in zip(crop_classes, resized):
            data[cls].append(crop)

    # negatives: proposals with max IoU <= 0.5 against same-frame GT
    if proposals is None:
        proposals = extract_train_proposals(
            train_dir, mser_cfg, cache_path=cache_path, limit=limit,
            grows=grows
        )
    for fname, (boxes, crops) in proposals.items():
        if len(boxes) == 0:
            continue
        gts = by_frame.get(fname, [])
        if gts:
            gt_boxes = np.array([[g.x1, g.y1, g.x2, g.y2] for g in gts], np.int32)
            ious = np.asarray(iou_matrix(boxes, gt_boxes))
            best = ious.max(axis=1)
            neg_mask = best <= NEGATIVE_IOU_MAX
            if proposal_positives:
                pos_mask = best > NEGATIVE_IOU_MAX
                pos_cls = np.array([gts[j].class_id for j in ious.argmax(axis=1)])
                for c, cls in zip(crops[pos_mask], pos_cls[pos_mask]):
                    data[int(cls)].append(c)
        else:
            neg_mask = np.ones(len(boxes), bool)
        for c in crops[neg_mask]:
            data[0].append(c)

    rng = np.random.default_rng(seed)
    out: dict[int, np.ndarray] = {}
    for c in range(7):
        arr = np.stack(data[c]) if data[c] else np.zeros((0, RECOG_CROP, RECOG_CROP), np.uint8)
        rng.shuffle(arr, axis=0)
        out[c] = arr
    return out


def split_validation(
    data: dict[int, np.ndarray], pct: float
) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
    """Per-class ordered split: first (1-pct) train, last pct validation."""
    train, val = {}, {}
    for c, arr in data.items():
        n_val = int(np.ceil(len(arr) * pct)) if len(arr) else 0
        cut = len(arr) - n_val
        train[c], val[c] = arr[:cut], arr[cut:]
    return train, val


def compute_features(crops: np.ndarray, features: str) -> np.ndarray:
    """[M, 32, 32] uint8 -> [M, D] float32 (HOG 324-d or GRAY 1024-d).

    The batch axis is zero-padded up to the next power of two (min 64)
    before the device call: per-class crop counts are all distinct, and an
    exact-shape jit would recompile the descriptor graph for every one of
    them (~14 XLA compiles per training run, minutes of wall clock for
    milliseconds of compute).
    """
    if len(crops) == 0:
        d = 324 if features == "HOG" else RECOG_CROP * RECOG_CROP
        return np.zeros((0, d), np.float32)
    fn = hog_descriptors if features == "HOG" else gray_descriptors
    m = len(crops)
    cap = max(64, 1 << (m - 1).bit_length())
    if cap != m:
        crops = np.concatenate(
            [crops, np.zeros((cap - m,) + crops.shape[1:], crops.dtype)]
        )
    return np.asarray(fn(jnp.asarray(crops)))[:m]


def compute_features_dict(
    data: dict[int, np.ndarray], features: str
) -> dict[int, np.ndarray]:
    """Per-class descriptor dict via ONE device call.

    Concatenates all classes' crops into a single padded batch: one upload
    and one compile instead of 14 per-class (each bucket-padded) ones.
    """
    sizes = {c: len(v) for c, v in data.items()}
    total = sum(sizes.values())
    if total == 0:
        return {c: compute_features(v, features) for c, v in data.items()}
    all_crops = np.concatenate(
        [data[c] for c in sorted(data) if sizes[c]]
    )
    feats = compute_features(all_crops, features)
    out: dict[int, np.ndarray] = {}
    off = 0
    for c in sorted(data):
        out[c] = feats[off : off + sizes[c]]
        off += sizes[c]
    return out


# ---------------------------------------------------------------------------
# Classifiers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SignClassifier:
    """Trained recognition model: six binary LDA heads or LDA+KNN."""

    config: ClassifierConfig
    heads: list[LDAParams] | None = None  # LDABAYES: one per super-type
    reducer: LDAParams | None = None  # KNN path
    knn: KNNParams | None = None
    # Proposal distribution the training data was mined with (detector
    # string + capacity/downscale).  Inference should keep its proposal
    # config matched to this: a tighter tuned detector starves the
    # classifier of candidates (measured AP 0.141 -> 0.048 on the test
    # set).  Informational; stored with the artifact so the coupling is
    # visible outside the training script.
    proposal_spec: str | None = None

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.txt"), "w") as f:
            f.write(self.config.to_string())
        if self.proposal_spec:
            with open(os.path.join(path, "proposal.txt"), "w") as f:
                f.write(self.proposal_spec)
        if self.heads:
            present = []
            for i, h in enumerate(self.heads):
                if h is not None:
                    h.save(os.path.join(path, f"head_{i + 1}.npz"))
                    present.append(str(i + 1))
            # manifest of intentionally-present heads: load() raises on a
            # missing listed file instead of silently predicting background
            with open(os.path.join(path, "heads.txt"), "w") as f:
                f.write(",".join(present))
        if self.reducer:
            self.reducer.save(os.path.join(path, "reducer.npz"))
        if self.knn:
            self.knn.save(os.path.join(path, "knn.npz"))

    @classmethod
    def load(cls, path: str) -> "SignClassifier":
        with open(os.path.join(path, "config.txt")) as f:
            config = ClassifierConfig.from_string(f.read().strip())
        heads = reducer = knn = None
        if config.classifier == "LDABAYES":
            manifest_path = os.path.join(path, "heads.txt")
            expected = None
            if os.path.exists(manifest_path):
                with open(manifest_path) as f:
                    txt = f.read().strip()
                expected = {int(s) for s in txt.split(",")} if txt else set()
            heads = []
            for i in range(6):
                hp = os.path.join(path, f"head_{i + 1}.npz")
                exists = os.path.exists(hp)
                if expected is not None and (i + 1) in expected and not exists:
                    raise FileNotFoundError(
                        f"classifier artifact at {path} is corrupt: manifest "
                        f"heads.txt lists head {i + 1} but {hp} is missing"
                    )
                heads.append(LDAParams.load(hp) if exists else None)
        else:
            reducer = LDAParams.load(os.path.join(path, "reducer.npz"))
            knn = KNNParams.load(os.path.join(path, "knn.npz"))
        spec_path = os.path.join(path, "proposal.txt")
        proposal_spec = None
        if os.path.exists(spec_path):
            with open(spec_path) as f:
                proposal_spec = f.read().strip()
        return cls(config=config, heads=heads, reducer=reducer, knn=knn,
                   proposal_spec=proposal_spec)


def fit_classifier(
    features_by_class: dict[int, np.ndarray],
    config: ClassifierConfig,
) -> SignClassifier:
    """Train the recognition model on class-keyed descriptor arrays."""
    if config.classifier == "LDABAYES":
        heads = []
        negatives = features_by_class[0]
        for t in range(1, 7):
            pos = features_by_class[t]
            if len(pos) == 0:
                # no positives for this super-type (small --limit runs):
                # the head can never assert its sign — model it as a None
                # head that predicts background with probability 1
                heads.append(None)
                continue
            X = np.concatenate([negatives, pos])
            y = np.concatenate([np.zeros(len(negatives)), np.full(len(pos), t)])
            heads.append(lda_fit(X, y))
        return SignClassifier(config=config, heads=heads)

    X = np.concatenate([features_by_class[c] for c in range(7)])
    y = np.concatenate(
        [np.full(len(features_by_class[c]), c) for c in range(7)]
    )
    reducer = lda_fit(X, y)
    reduced = np.asarray(lda_transform(reducer, X))
    knn = knn_fit(reduced, y, k=config.knn_neighbors)
    return SignClassifier(config=config, reducer=reducer, knn=knn)


def arbitrate_lda_heads(
    probs: jnp.ndarray, tol: float, sign_margin: float = 0.0
) -> jnp.ndarray:
    """The reference's extractBestPredictions rule, vectorized.

    probs: [6, N, 2] per-head (background, sign) probabilities.
    Per instance: each head votes (max prob, 0 if background wins else its
    type).  If no head asserts a sign with prob > tol -> class 0; otherwise
    the sign-asserting head with the highest confidence wins (first head on
    ties, like Python max).  (`Reconocimiento de Objetos/source.py:627-641`.)

    ``sign_margin`` (framework knob, no reference equivalent; default 0 =
    parity): a head asserts "sign" when ``p_sign >= 0.5 - margin`` instead
    of ``p_sign >= p_background``.  The reference's tol dial is inert below
    0.5 (head confidence = max(p0, p1) >= 0.5 by construction), so this is
    the only way to trade precision for recall on the sign side.
    """
    no_sign_p = probs[..., 0]  # [6, N]
    sign_p = probs[..., 1]
    if sign_margin > 0.0:
        head_says_sign = sign_p >= 0.5 - sign_margin
        head_conf = jnp.where(head_says_sign, sign_p, no_sign_p)
        asserted = head_says_sign & (head_conf > tol - sign_margin)
    else:
        head_says_sign = sign_p >= no_sign_p  # ties -> sign (p0 > p1 is "no")
        head_conf = jnp.maximum(no_sign_p, sign_p)
        asserted = head_says_sign & (head_conf > tol)
    any_sign = jnp.any(asserted, axis=0)  # [N]
    score = jnp.where(head_says_sign, head_conf, -jnp.inf)  # [6, N]
    best_head = jnp.argmax(score, axis=0)  # [N]
    return jnp.where(any_sign, best_head + 1, 0).astype(jnp.int32)


def predict_classifier(
    clf: SignClassifier, X: np.ndarray, no_sign_tol: float = 0.5
) -> np.ndarray:
    """[N, D] descriptors -> [N] predicted classes 0..6."""
    if len(X) == 0:
        return np.zeros((0,), np.int32)
    if clf.config.classifier == "LDABAYES":
        always_bg = jnp.tile(
            jnp.asarray([1.0, 0.0], jnp.float32), (len(X), 1)
        )
        probs = jnp.stack(
            [
                lda_predict_proba(h, X) if h is not None else always_bg
                for h in clf.heads
            ]
        )  # [6, N, 2]
        return np.asarray(arbitrate_lda_heads(probs, no_sign_tol))
    reduced = lda_transform(clf.reducer, X)
    return np.asarray(knn_predict(clf.knn, reduced)).astype(np.int32)


# ---------------------------------------------------------------------------
# Validation harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ValidationResult:
    confusion: np.ndarray
    report: str
    accuracy: float
    y_true: np.ndarray
    y_pred: np.ndarray
    classifier: SignClassifier


def run_validation(
    train_dir: str,
    mser_cfg: MSERConfig | None = None,
    clf_cfg: ClassifierConfig | None = None,
    validation_pct: float = 0.1,
    no_sign_tol: float = 0.5,
    cache_path: str | None = None,
    limit: int | None = None,
    seed: int = 0,
    verbose: bool = False,
    mesh=None,
    proposal_positives: bool = False,
    grows: tuple[float, ...] = (RECOG_GROW,),
    proposals: dict[str, tuple[np.ndarray, np.ndarray]] | None = None,
) -> ValidationResult:
    """Train on (1-pct) of the per-class data, validate on the held-out pct.

    With ``mesh`` (a `jax.sharding.Mesh`), LDABAYES heads are fit by the
    SPMD sufficient-statistics trainer (`parallel.train`) with descriptors
    sharded over the mesh — the multi-chip product path.
    """
    mser_cfg = mser_cfg or MSERConfig()
    clf_cfg = clf_cfg or ClassifierConfig()

    if verbose:
        print("building training data (positives + mined negatives)...")
    data = build_training_data(
        train_dir, mser_cfg=mser_cfg, cache_path=cache_path, limit=limit,
        seed=seed, proposal_positives=proposal_positives, grows=grows,
        proposals=proposals,
    )
    train, val = split_validation(data, validation_pct)

    if verbose:
        sizes = {c: len(v) for c, v in data.items()}
        print(f"class sizes: {sizes}")
        print(f"computing {clf_cfg.features} descriptors...")
    train_feats = compute_features_dict(train, clf_cfg.features)
    val_feats = compute_features_dict(val, clf_cfg.features)

    if verbose:
        print(f"fitting {clf_cfg.classifier} ..." +
              (f" (SPMD over {mesh.devices.size} devices)" if mesh else ""))
    if mesh is not None:
        from ..parallel.train import fit_classifier_distributed

        clf = fit_classifier_distributed(train_feats, clf_cfg, mesh)
    else:
        clf = fit_classifier(train_feats, clf_cfg)

    Xv = np.concatenate([val_feats[c] for c in range(7)])
    yv = np.concatenate([np.full(len(val_feats[c]), c) for c in range(7)])
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(yv))
    Xv, yv = Xv[perm], yv[perm]

    clf.proposal_spec = (
        f"{mser_cfg.to_string()};max_regions={mser_cfg.max_regions};"
        f"downscale={mser_cfg.downscale};"
        f"grows={','.join(f'{g:g}' for g in grows)}"
    )
    y_pred = predict_classifier(clf, Xv, no_sign_tol)
    labels = list(range(7))
    cm = confusion_matrix(yv, y_pred, labels)
    rep = classification_report(yv, y_pred, labels, target_names=list(SIGN_NAMES))
    acc = float((yv == y_pred).mean()) if len(yv) else 0.0
    return ValidationResult(
        confusion=cm, report=rep, accuracy=acc, y_true=yv, y_pred=y_pred,
        classifier=clf,
    )
