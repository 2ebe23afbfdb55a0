"""Public embedding API — Python mirror of the reference C ABI.

Reference: ``extern "C" void ray_trace(samples, storeRenderResult, width,
height, gpu_count)`` (/root/reference/src/ray_trace.h:9-15,
src/ray_trace.cpp:922-972).  ``ray_trace`` here takes the same five arguments
in the same order with the same defaults, prints ``duration_per_frame`` like
the reference frame loop (ray_trace.cpp:745), and — unlike the reference,
which parses ``--store`` but never writes (quirk Q2) — actually stores a PNG
when asked.  A C-callable shared library wrapping this function is provided
under ``native/`` for ctypes embedding parity (scripts/test.py analogue).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import RenderConfig
from .models.scene import SceneArrays


def render_image(config: RenderConfig, scene: Optional[SceneArrays] = None) -> np.ndarray:
    """Render one frame to a u8 RGB image using ``config``."""
    if config.chips > 1:
        from .parallel.sharding import MultiChipRenderer

        return MultiChipRenderer(config, scene=scene).render_u8()
    from .runtime.renderer import Renderer

    return Renderer(config, scene=scene).render_u8()


def ray_trace(
    samples: int = 10,
    store_render_result: bool = False,
    width: int = 1920,
    height: int = 1080,
    gpu_count: int = 1,
    *,
    out_path: str = "render.png",
    scene_time: float = 0.0,
    backend: str = "auto",
    max_depth: int = 50,
    samples_per_call: Optional[int] = None,
    accum_dtype: str = "float32",
    preview: bool = False,
    pixels_per_lane: Optional[int] = None,
    mode: str = "exact",
) -> np.ndarray:
    """Drop-in analogue of the reference C ABI entry point.

    Renders the procedural final-book scene at (width, height) with ``samples``
    spp across ``gpu_count`` devices, prints duration_per_frame, optionally
    stores a PNG, and returns the u8 image.
    """
    import time

    config = RenderConfig(
        samples=samples,
        store=store_render_result,
        width=width,
        height=height,
        chips=gpu_count,
        max_depth=max_depth,
        samples_per_call=samples_per_call,
        backend=backend,
        scene_time=scene_time,
        out_path=out_path,
        accum_dtype=accum_dtype,
        pixels_per_lane=pixels_per_lane,
        mode=mode,
    )
    t0 = time.perf_counter()
    if preview and gpu_count == 1:
        # progressive preview: write the running image after every call —
        # the headless analogue of the reference's live window (window.hpp)
        from .ops.image import accum_to_u8
        from .runtime.renderer import Renderer
        from .utils.png import write_png

        import dataclasses

        if config.samples_per_call is None:
            config = dataclasses.replace(
                config, samples_per_call=max(1, samples // 10))
        r = Renderer(config)

        def on_chunk(accum, done):
            write_png(out_path, np.asarray(accum_to_u8(accum, done)))

        accum, total = r.render(samples, on_chunk=on_chunk)
        img = np.asarray(accum_to_u8(accum, total))
    else:
        img = render_image(config)
    dpf = time.perf_counter() - t0
    print(f"duration_per_frame: {dpf}")
    if store_render_result:
        from .utils.png import write_png

        write_png(out_path, img)
    return img
