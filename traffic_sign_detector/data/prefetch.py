"""Host input pipeline: decode-ahead batching.

Decodes and assembles the next frame batch on a background thread while the
device crunches the current one, overlapping JPEG decode (native C++ loader)
with device compute — the input-pipeline-overlap stage of the scale-out plan
(SURVEY.md §7.8).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .images import load_frames_batch


def batched_frames(
    directory: str,
    files: list[str],
    batch_size: int,
    prefetch: int = 2,
    device_put: bool = False,
    input_format: str = "bgr",
):
    """Yield (frames [B,H,W,3], names [B]) with background decode-ahead.

    The tail batch is padded by repeating the last frame; padded slots get
    the name "__pad__".  With ``device_put=True`` the producer thread also
    uploads each batch (`jax.device_put`), overlapping the host->device
    transfer of batch i+1 with the device compute of batch i.

    ``input_format`` selects the decode layout:

    * ``"bgr"``      — [B, H, W, 3] uint8 (default; cv2.imread parity).
    * ``"yuv420"``   — items are ((y, cb, cr), names): raw JPEG 4:2:0
      planes at 1.5 bytes/px, halving the host->device upload; consume
      with ``CNNDetector.dispatch_yuv``.
    * ``"yuv420p"``  — same planes PATCHIFIED at decode time
      (y [B,H/8,W/8,64], cb/cr [B,H/8,W/8,16]): same bytes, and the v3
      stem consumes the converted result with zero on-device relayout
      (ops/yuv.py: yuv420_patches_to_bgr_patches8).  Falls back to tight
      planes, then to BGR.
    * ``"patches8"`` — [B, H/8, W/8, 192] uint8: same bytes as BGR,
      repacked at decode time into the stem's matmul layout (zero
      on-device relayout).

    Both non-BGR formats fall back to BGR items automatically when the
    native decoder is unavailable, so callers must key on the item's
    structure (tuple-of-3, or ndim/last-dim).
    """

    def assemble(chunk: list[str]):
        names = list(chunk)
        pad = batch_size - len(chunk)
        if input_format in ("yuv420", "yuv420p"):
            from .images import (
                load_frames_yuv420_batch,
                load_frames_yuv420_patches_batch,
            )

            if input_format == "yuv420p":
                # patchified planes (zero on-device relayout); falls back
                # to tight planes, then to BGR frames
                planes = load_frames_yuv420_patches_batch(directory, chunk)
                if planes is None:
                    planes = load_frames_yuv420_batch(directory, chunk)
            else:
                planes = load_frames_yuv420_batch(directory, chunk)
            if planes is not None:
                if pad:
                    planes = tuple(
                        np.concatenate([p, p[-1:].repeat(pad, 0)])
                        for p in planes
                    )
                    names += ["__pad__"] * pad
                if device_put:
                    import jax

                    planes = tuple(jax.device_put(p) for p in planes)
                return planes, names
        frames = None
        if input_format == "patches8":
            from .images import load_frames_patches8_batch

            frames = load_frames_patches8_batch(directory, chunk)
        if frames is None:
            # threaded native batch decode (runtime/loader.cpp worker pool)
            frames = load_frames_batch(directory, chunk)
        if pad:
            frames = np.concatenate([frames, frames[-1:].repeat(pad, 0)])
            names += ["__pad__"] * pad
        if device_put:
            import jax

            frames = jax.device_put(frames)
        return frames, names

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for start in range(0, len(files), batch_size):
                if stop.is_set():
                    return
                q.put(assemble(files[start : start + batch_size]))
        except Exception as e:  # surface decode errors on the consumer side
            q.put(e)
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the producer can exit promptly
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
