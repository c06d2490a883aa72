import time

from traffic_sign_detector.utils.profiling import (
    StageProfiler,
    device_sync,
)


def test_stage_profiler_accumulates():
    prof = StageProfiler()
    with prof.stage("load", items=4):
        time.sleep(0.01)
    with prof.stage("load", items=4):
        pass
    with prof.stage("detect", items=4):
        time.sleep(0.005)
    s = prof.stages["load"]
    assert s.calls == 2 and s.items == 8
    assert s.total_s >= 0.01
    txt = prof.summary()
    assert "load" in txt and "detect" in txt and "items/s" in txt


def test_device_sync_runs():
    device_sync()
