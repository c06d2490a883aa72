import numpy as np
import pytest

from traffic_sign_detector.data.prefetch import batched_frames


def test_batched_frames_real_dir(test_frames_dir):
    from traffic_sign_detector.data.images import list_frame_files

    files = list_frame_files(str(test_frames_dir))[:5]
    batches = list(batched_frames(str(test_frames_dir), files, batch_size=2))
    assert len(batches) == 3
    frames, names = batches[0]
    assert frames.shape == (2, 800, 1360, 3)
    assert names == files[:2]
    tail_frames, tail_names = batches[-1]
    assert tail_names == [files[4], "__pad__"]
    np.testing.assert_array_equal(tail_frames[0], tail_frames[1])


def test_batched_frames_error_propagates(tmp_path):
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(Exception):
        list(batched_frames(str(tmp_path), ["bad.jpg"], batch_size=1))
