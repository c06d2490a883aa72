"""Native C++ JPEG loader: build + decode parity with the PIL fallback."""

import numpy as np
import pytest

from traffic_sign_detector.runtime import loader


@pytest.fixture(scope="module")
def built():
    if not loader.available():
        pytest.skip("native loader toolchain unavailable")
    return True


def test_decode_matches_reference_decoder(built, test_frames_dir):
    cv2 = pytest.importorskip("cv2")
    p = str(test_frames_dir / "00600.jpg")
    ours = loader.decode_jpeg_bgr(p)
    ref = cv2.imread(p)
    assert ours is not None
    np.testing.assert_array_equal(ours, ref)


def test_batch_decode(built, test_frames_dir):
    import os

    files = [
        str(test_frames_dir / f)
        for f in sorted(os.listdir(test_frames_dir))
        if f.endswith(".jpg")
    ][:6]
    batch = loader.decode_jpeg_bgr_batch(files)
    assert batch is not None and len(batch) == 6
    single = loader.decode_jpeg_bgr(files[3])
    np.testing.assert_array_equal(batch[3], single)


def test_probe_size(built, test_frames_dir):
    assert loader.probe_size(str(test_frames_dir / "00600.jpg")) == (800, 1360)


def test_images_module_uses_native_path(built, test_frames_dir):
    from traffic_sign_detector.data.images import load_image_bgr

    img = load_image_bgr(str(test_frames_dir / "00600.jpg"))
    assert img.shape == (800, 1360, 3)


# ---------------------------------------------------------------------------
# Half-bandwidth YUV 4:2:0 ingest (raw planes + device-side conversion)
# ---------------------------------------------------------------------------


def test_yuv420_roundtrip_bit_exact(built, tmp_path, test_frames_dir):
    """On a true 4:2:0 JPEG, raw planes + ops.yuv.yuv420_to_bgr must be
    byte-identical to libjpeg's own full BGR decode of the same file
    (fancy upsample + fixed-point ycc->rgb, reproduced exactly)."""
    from PIL import Image

    from traffic_sign_detector.ops.yuv import yuv420_to_bgr

    src = str(test_frames_dir / "00600.jpg")
    p = str(tmp_path / "f420.jpg")
    Image.open(src).save(p, quality=90, subsampling=2)  # force 4:2:0

    full = loader.decode_jpeg_bgr(p)
    planes = loader.decode_jpeg_yuv420(p)
    assert planes is not None
    y, cb, cr = planes
    assert y.shape == full.shape[:2]
    assert cb.shape == ((full.shape[0] + 1) // 2, (full.shape[1] + 1) // 2)
    ours = np.asarray(yuv420_to_bgr(y, cb, cr))
    np.testing.assert_array_equal(ours, full)


def test_yuv420_odd_dimensions_bit_exact(built, tmp_path):
    """Odd frame sizes exercise the edge-replication rows/cols of the
    upsampler and the ceil-division chroma extents."""
    from PIL import Image

    from traffic_sign_detector.ops.yuv import yuv420_to_bgr

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (61, 47, 3), np.uint8)
    p = str(tmp_path / "odd420.jpg")
    Image.fromarray(img).save(p, quality=85, subsampling=2)
    full = loader.decode_jpeg_bgr(p)
    planes = loader.decode_jpeg_yuv420(p)
    assert planes is not None
    y, cb, cr = planes
    assert y.shape == (61, 47) and cb.shape == (31, 24)
    np.testing.assert_array_equal(np.asarray(yuv420_to_bgr(y, cb, cr)), full)


def test_yuv420_batch_matches_single(built, test_frames_dir):
    import os

    files = [
        str(test_frames_dir / f)
        for f in sorted(os.listdir(test_frames_dir))
        if f.endswith(".jpg")
    ][:4]
    out = loader.decode_jpeg_yuv420_batch(files)
    assert out is not None
    y, cb, cr = out
    assert y.shape == (4, 800, 1360) and cb.shape == (4, 400, 680)
    sy, scb, scr = loader.decode_jpeg_yuv420(files[2])
    np.testing.assert_array_equal(y[2], sy)
    np.testing.assert_array_equal(cb[2], scb)
    np.testing.assert_array_equal(cr[2], scr)


def test_yuv420_repack_of_444_source(built, test_frames_dir):
    """GTSDB frames are 4:4:4: the loader average-pools chroma to 4:2:0.
    The result is not byte-equal to the full decode (that's the point —
    half the bytes), but luma must be EXACT and chroma loss small."""
    from traffic_sign_detector.ops.yuv import yuv420_to_bgr

    p = str(test_frames_dir / "00600.jpg")
    full = loader.decode_jpeg_bgr(p).astype(np.int32)
    y, cb, cr = loader.decode_jpeg_yuv420(p)
    ours = np.asarray(yuv420_to_bgr(y, cb, cr)).astype(np.int32)
    # libjpeg gray (BT.601 luma) of both decodes must agree closely: the
    # repack touches chroma only.
    d = np.abs(ours - full)
    assert d.mean() < 1.5, f"chroma repack drifted too far: mean {d.mean()}"
    gray_full = (full @ [0.114, 0.587, 0.299])
    gray_ours = (ours @ [0.114, 0.587, 0.299])
    assert np.abs(gray_full - gray_ours).mean() < 0.35


def test_prefetch_yuv420_lane(built, test_frames_dir):
    """batched_frames(yuv420=True) yields plane tuples with pad names."""
    import os

    from traffic_sign_detector.data.prefetch import batched_frames

    files = [
        f for f in sorted(os.listdir(test_frames_dir)) if f.endswith(".jpg")
    ][:5]
    items = list(
        batched_frames(str(test_frames_dir), files, batch_size=3,
                       input_format="yuv420")
    )
    assert len(items) == 2
    planes, names = items[1]
    assert isinstance(planes, tuple) and len(planes) == 3
    assert planes[0].shape == (3, 800, 1360)
    assert names[-1] == "__pad__"


# ---------------------------------------------------------------------------
# patches8 decode layout (host-side patchify into the stem matmul layout)
# ---------------------------------------------------------------------------


def test_patches8_matches_bgr_repack(built, test_frames_dir):
    """patches8 is the BGR decode repacked: [h/8, w/8, 192] with
    k = ky*24 + kx*3 + c (flattened HWIO), byte-for-byte."""
    p = str(test_frames_dir / "00600.jpg")
    bgr = loader.decode_jpeg_bgr(p)
    pat = loader.decode_jpeg_bgr_patches8_batch([p])
    assert pat is not None and pat.shape == (1, 100, 170, 192)
    h, w, _ = bgr.shape
    ref = (
        bgr.reshape(h // 8, 8, w // 8, 24)
        .transpose(0, 2, 1, 3)
        .reshape(h // 8, w // 8, 192)
    )
    np.testing.assert_array_equal(pat[0], ref)


def test_patches8_stem_equals_frames_stem(built, test_frames_dir):
    """The v3 model produces identical detections from frames and from
    the patches8 layout of the same bytes."""
    import jax.numpy as jnp

    from traffic_sign_detector.models import cnn_detector as cd

    p = str(test_frames_dir / "00600.jpg")
    bgr = loader.decode_jpeg_bgr(p)[:256, :320]  # small crop: fast on CPU
    pat = (
        bgr.reshape(32, 8, 40, 24)
        .transpose(0, 2, 1, 3)
        .reshape(1, 32, 40, 192)
    )
    cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8,
                               score_threshold=0.05)
    params = cd.init_params(0)
    o1 = cd._detect_jit(cfg, params, jnp.asarray(bgr[None]), 8, 0.05)
    o2 = cd._detect_jit(cfg, params, jnp.asarray(pat), 8, 0.05)
    np.testing.assert_allclose(np.asarray(o1[2]), np.asarray(o2[2]),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(o1[3]), np.asarray(o2[3]))


def test_prefetch_patches8_lane(built, test_frames_dir):
    import os

    from traffic_sign_detector.data.prefetch import batched_frames

    files = [
        f for f in sorted(os.listdir(test_frames_dir)) if f.endswith(".jpg")
    ][:3]
    items = list(
        batched_frames(str(test_frames_dir), files, batch_size=3,
                       input_format="patches8")
    )
    assert len(items) == 1
    frames, names = items[0]
    assert frames.shape == (3, 100, 170, 192)


def test_yuv420_patches_matches_host_repack(built, test_frames_dir):
    """Native patchified-plane decode == tight planes + numpy repack
    (ops/yuv.py: patchify_yuv_planes), byte for byte."""
    import os

    from traffic_sign_detector.ops.yuv import patchify_yuv_planes

    files = [
        str(test_frames_dir / f)
        for f in sorted(os.listdir(test_frames_dir))
        if f.endswith(".jpg")
    ][:3]
    got = loader.decode_jpeg_yuv420_patches_batch(files)
    assert got is not None
    tight = loader.decode_jpeg_yuv420_batch(files)
    want = patchify_yuv_planes(*tight)
    assert got[0].shape == (3, 100, 170, 64)
    assert got[1].shape == got[2].shape == (3, 100, 170, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_yuv420_patches_conversion_bit_exact(built, test_frames_dir):
    """Patch-space conversion on real loader output == full-plane
    yuv420_to_bgr + 8x8 patchify, bit for bit (the libjpeg integer math
    survives the patch-space reformulation)."""
    import jax.numpy as jnp

    from traffic_sign_detector.ops.yuv import (
        patchify_yuv_planes,
        yuv420_patches_to_bgr_patches8,
        yuv420_to_bgr,
    )

    p = str(test_frames_dir / "00600.jpg")
    y, cb, cr = loader.decode_jpeg_yuv420(p)
    y, cb, cr = y[None], cb[None], cr[None]
    bgr = np.asarray(yuv420_to_bgr(jnp.asarray(y), jnp.asarray(cb),
                                   jnp.asarray(cr)))
    b, h, w, _ = bgr.shape
    want = (bgr.reshape(b, h // 8, 8, w // 8, 8, 3)
            .transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 8, w // 8, 192))
    yp, cbp, crp = patchify_yuv_planes(y, cb, cr)
    got = np.asarray(yuv420_patches_to_bgr_patches8(
        jnp.asarray(yp), jnp.asarray(cbp), jnp.asarray(crp)))
    np.testing.assert_array_equal(got, want)


def test_prefetch_yuv420p_lane(built, test_frames_dir):
    """batched_frames(input_format="yuv420p") yields patchified plane
    tuples; CNNDetector.dispatch_yuv keys on their ndim."""
    from traffic_sign_detector.data.prefetch import batched_frames

    import os

    files = sorted(f for f in os.listdir(test_frames_dir)
                   if f.endswith(".jpg"))[:3]
    items = list(batched_frames(str(test_frames_dir), files, 2,
                                input_format="yuv420p"))
    assert len(items) == 2
    (planes, names) = items[0]
    assert isinstance(planes, tuple) and len(planes) == 3
    assert planes[0].ndim == 4 and planes[0].shape[-1] == 64
    assert planes[1].shape[-1] == 16
    (planes2, names2) = items[1]
    assert names2[-1] == "__pad__"


def test_dispatch_yuv_patches_agrees_with_tight_planes(built,
                                                       test_frames_dir):
    """CNNDetector.dispatch_yuv on patchified planes must produce the same
    detections as on tight planes: the conversion is bit-exact, so only
    jit-boundary float reassociation can differ — scores must match."""
    import os

    import jax.numpy as jnp

    from traffic_sign_detector.models import cnn_detector as cd

    ckpt = "artifacts/cnn_detector/params.npz"
    if not os.path.exists(ckpt):
        pytest.skip("shipped checkpoint not present")
    det = cd.CNNDetector.load(ckpt)
    from traffic_sign_detector.ops.yuv import patchify_yuv_planes

    files = [
        str(test_frames_dir / f)
        for f in sorted(os.listdir(test_frames_dir))
        if f.endswith(".jpg")
    ][:2]
    y, cb, cr = loader.decode_jpeg_yuv420_batch(files)
    tight = [np.asarray(o) for o in det.dispatch_yuv(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))]
    yp, cbp, crp = patchify_yuv_planes(y, cb, cr)
    patched = [np.asarray(o) for o in det.dispatch_yuv(
        jnp.asarray(yp), jnp.asarray(cbp), jnp.asarray(crp))]
    np.testing.assert_allclose(np.sort(patched[2], -1),
                               np.sort(tight[2], -1), atol=2e-3)
    # the top real detections (score > 0.5) must be the same boxes
    for b in range(tight[0].shape[0]):
        mask = tight[2][b] > 0.5
        if not mask.any():
            continue
        tb = np.sort(tight[0][b][mask], axis=0)
        pm = patched[2][b] > 0.5
        pb = np.sort(patched[0][b][pm], axis=0)
        assert tb.shape == pb.shape
        np.testing.assert_allclose(tb, pb, atol=1.0)
