import numpy as np

from traffic_sign_detector.data.images import stack_frames
from traffic_sign_detector.utils.annotate import draw_boxes_bgr
from traffic_sign_detector.utils.serialization import (
    detections_to_lines,
)
from traffic_sign_detector.data.gt import GroundTruthBox


def test_draw_boxes_edges_and_clipping():
    img = np.zeros((20, 30, 3), np.uint8)
    out = draw_boxes_bgr(img, [(5, 5, 10, 10), (-5, -5, 50, 50)])
    assert img.sum() == 0  # original untouched
    assert (out[5, 5:11] == (0, 0, 255)).all()
    assert (out[0, :] == (0, 0, 255)).all()  # clipped big box hugs the edge


def test_stack_frames_dict_sorted():
    d = {"b.jpg": np.ones((4, 4, 3), np.uint8),
         "a.jpg": np.zeros((4, 4, 3), np.uint8)}
    names, arr = stack_frames(d)
    assert names == ["a.jpg", "b.jpg"]
    assert arr.shape == (2, 4, 4, 3)
    assert arr[0].sum() == 0


def test_detection_line_format_matches_reference():
    d = GroundTruthBox(filename="00600.jpg", x1=1, y1=2, x2=3, y2=4,
                       class_id=6, score=0.98)
    assert detections_to_lines([d]) == ["00600.jpg;1;2;3;4;6;0.98"]
    d2 = GroundTruthBox(filename="a.jpg", x1=0, y1=0, x2=1, y2=1,
                        class_id=1, score=0.6000000001)
    assert detections_to_lines([d2]) == ["a.jpg;0;0;1;1;1;0.6"]
