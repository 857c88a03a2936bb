"""Phase timers, a throughput meter and a device trace (counterpart of
`mcpt_tpu/utils/profiling.py`).

`PhaseTimer` accumulates named host-side phases, `ThroughputMeter` turns ray
and path counts into rates, and `device_trace(log_dir)` records a
`torch.profiler` trace of the CPU and, where there is a card, of the CUDA
activity, written as a Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) into `log_dir`.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulating named timers: scene compile, BVH build, trace, I/O."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.totals[name] += time.monotonic() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"  {name:<24} {self.totals[name]:8.3f}s  x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "phase timings:\n" + "\n".join(lines) if lines else "no phases"


class ThroughputMeter:
    """Rays/s and paths/s since the meter was made."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.rays = 0
        self.paths = 0

    def add(self, rays: int, paths: int) -> None:
        self.rays += int(rays)
        self.paths += int(paths)

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def report(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "rays": self.rays,
            "paths": self.paths,
            "rays_per_s": self.rays / dt,
            "paths_per_s": self.paths / dt,
            "elapsed_s": dt,
        }


@contextlib.contextmanager
def device_trace(log_dir):
    """A torch.profiler trace of the block (CPU activity, and CUDA activity
    where a card is present) written to `log_dir`/trace.json when `log_dir`
    is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
