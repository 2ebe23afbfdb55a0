"""Profiling/observability — the reference has host wall-clocks only
(SURVEY.md §5: std::chrono around the frame loop); here we add real device
traces via jax.profiler plus structured per-call timing.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a TensorBoard-viewable device trace around a block.

    Usage::
        with device_trace("/tmp/trace"):
            renderer.render_call(100)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class FrameStats:
    """Rolling duration_per_frame bookkeeping (ray_trace.cpp:741-748)."""

    durations: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - t0)

    @property
    def duration_per_frame(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)

    def adaptive_frame_count(self, min_seconds: float = 4.0) -> int:
        """benchmark_frame_count = (min_s + 50*dpf)/dpf (ray_trace.cpp:748)."""
        dpf = self.duration_per_frame
        if dpf <= 0:
            return 1
        return max(1, int((min_seconds + 50.0 * dpf) / dpf))

    def report(self) -> Dict:
        d = self.durations
        return {
            "frames": len(d),
            "duration_per_frame": self.duration_per_frame,
            "min": min(d) if d else 0.0,
            "max": max(d) if d else 0.0,
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.report())
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
