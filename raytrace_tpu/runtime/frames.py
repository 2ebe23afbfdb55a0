"""Animated frame loop — the reference's interactive rendering mode.

The reference regenerates the scene every frame with wall-clock-animated
hero spheres (scene.h:82-116, quirk Q8) and presents each GPU's band to its
own window (window.hpp).  Headless equivalent: a frame loop that
advances the animation time explicitly, re-uploads the (tiny) scene tables
each frame, measures duration_per_frame with the reference's adaptive
window (ray_trace.cpp:86,741-748), and optionally writes numbered PNGs in
place of presentation.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..config import RenderConfig
from ..models.scene import generate_random_scene
from ..ops import image as imageops
from .renderer import Renderer


class FrameLoop:
    """Renders animated frames; one Renderer, scene re-prepared per frame."""

    def __init__(self, config: RenderConfig, time_fn: Optional[Callable[[], float]] = None):
        self.config = config
        self.time_fn = time_fn if time_fn is not None else time.monotonic
        self.renderer = Renderer(config, scene=generate_random_scene(0.0))

    def render_frame(self, t: Optional[float] = None) -> np.ndarray:
        """One frame at animation time ``t`` (wall clock if None, like the
        reference).  Returns the accumulated sum [H, W, 3]."""
        t = self.time_fn() if t is None else t
        self.renderer.set_scene(generate_random_scene(t))
        return self.renderer.render_call(self.config.samples)

    def run(self, frames: int = 0, min_seconds: float = 4.0,
            store_pattern: Optional[str] = None, animate: bool = True):
        """Frame loop with the reference's measurement-window semantics.

        frames=0: adaptive count = (min_seconds + 50*dpf) / dpf, like
        benchmark_frame_count at ray_trace.cpp:86,748.  Returns
        (duration_per_frame seconds, frames rendered).
        """
        # warm up / compile (np.asarray waits for the device)
        np.asarray(self.render_frame(0.0))
        t0 = time.perf_counter()
        np.asarray(self.render_frame(0.0 if not animate else None))
        dpf = time.perf_counter() - t0
        if frames <= 0:
            frames = max(1, min(int((min_seconds + 50.0 * dpf) / max(dpf, 1e-9)), 1000))
        # render-only timing: the reference's duration_per_frame excludes any
        # host-side I/O (ray_trace.cpp:741-745 brackets only the frame loop).
        # PNG encode + disk writes happen outside the measured span; the
        # per-frame fetch to host (np.asarray) doubles as the completion
        # barrier.
        render_time = 0.0
        for i in range(frames):
            t0 = time.perf_counter()
            accum = self.render_frame(0.0 if not animate else None)
            if store_pattern:
                img = np.asarray(imageops.accum_to_u8(accum, self.config.samples))
            else:
                img = None
                np.asarray(accum)  # force device completion
            render_time += time.perf_counter() - t0
            if store_pattern:
                from ..utils.png import write_png

                write_png(store_pattern.format(i), img)
        dpf = render_time / frames
        print(f"duration_per_frame: {dpf}")
        return dpf, frames
