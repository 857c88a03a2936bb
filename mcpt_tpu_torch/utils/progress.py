"""Console progress bar and wall-clock formatting (counterpart of
`mcpt_tpu/utils/progress.py`).

The reference's `src/global.hpp:55-70` (`UpdateProgress`) and
`src/main.cpp:336-348` (H:M:S.ms report), host-side only.
"""

import sys
import time


def format_duration(seconds: float) -> str:
    ms = int(round(seconds * 1000.0))
    hrs, ms = divmod(ms, 3600_000)
    mins, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1000)
    return f"{hrs}:{mins}:{secs}.{ms}"


class ProgressBar:
    """70-char console bar, throttled to avoid spamming slow terminals."""

    def __init__(self, width: int = 70, stream=None, min_interval: float = 0.1):
        self.width = width
        self.stream = stream if stream is not None else sys.stdout
        self.min_interval = min_interval
        self._last = 0.0
        self._start = time.monotonic()

    def update(self, progress: float, force: bool = False) -> None:
        now = time.monotonic()
        if not force and (now - self._last) < self.min_interval and progress < 1.0:
            return
        self._last = now
        progress = min(max(progress, 0.0), 1.0)
        pos = int(self.width * progress)
        bar = "=" * pos + (">" if pos < self.width else "") + " " * max(self.width - pos - 1, 0)
        self.stream.write(f"[{bar}] {int(progress * 100)} %\r")
        self.stream.flush()

    def finish(self) -> float:
        self.update(1.0, force=True)
        self.stream.write("\n")
        self.stream.flush()
        return time.monotonic() - self._start
