"""`mcpt_tpu_torch.utils.profiling` on the CPU: a wavefront render with
`trace_dir` writes a torch.profiler Chrome trace, and its image and ray
count are bitwise those of the render without it; the phase timer and the
throughput meter count what they are given."""

import dataclasses
import json

import numpy as np

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.render import render_radiance
from mcpt_tpu_torch.utils.profiling import TRACE_FILE, PhaseTimer, ThroughputMeter, device_trace


def test_render_with_trace_is_bitwise_the_render(tmp_path):
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=8, height=8)
    kw = dict(max_bounces=3, method="dense", device="cpu")
    plain, s1 = render_radiance(sc, cam, 2, 1, **kw)
    traced, s2 = render_radiance(sc, cam, 2, 1, trace_dir=str(tmp_path / "trace"), **kw)
    assert np.array_equal(plain, traced) and s1["rays"] == s2["rays"]
    events = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_device_trace_off_writes_nothing(tmp_path):
    with device_trace(None):
        pass
    with device_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_phase_timer_and_meter():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert "a" in timer.report() and PhaseTimer().report() == "no phases"
    meter = ThroughputMeter()
    meter.add(10, 2)
    meter.add(5, 1)
    rep = meter.report()
    assert (rep["rays"], rep["paths"]) == (15, 3) and rep["rays_per_s"] > 0
