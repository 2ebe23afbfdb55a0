"""Heterogeneous multi-device dispatch + auto-tuned row-band balancing.

The faithful analogue of the reference's multi-GPU architecture
(/root/reference/src/ray_trace.cpp:42-920 + workload_tuner.hpp): each device
renders its own row band *independently* — no collectives, just per-device
dispatch — and a tuner re-splits rows between measurement windows based on
per-device busy-time estimates.  The reference tears down and rebuilds all
Vulkan resources every tuning round (:778-915); here a re-split just changes
band heights, i.e. jit cache keys (the persistent compile cache absorbs the
rebuild cost).

Use ``MultiChipRenderer`` (sharding.py) for homogeneous devices — a static
equal split over a Mesh is optimal there.  This path exists for heterogeneous
pools and for architecture parity, and is exercised on the virtual CPU mesh
in tests.

Timing model: per-device busy time is measured host-side as dispatch-to-ready
wall time of the device's band (the analogue of the reference's
acquire-present probe, ray_trace.cpp:609-644).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import jax
import numpy as np

from ..config import RenderConfig
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops.trace import prepare_scene, render_band, viewport_arrays
from ..runtime.renderer import (config_camera, default_pixels_per_lane,
                                resolve_backend)
from ..runtime.tuner import make_tuner


class HeteroRenderer:
    """Per-device band dispatch with dynamic row rebalancing."""

    def __init__(
        self,
        config: RenderConfig,
        scene: Optional[SceneArrays] = None,
        devices: Optional[Sequence] = None,
        reference_banding: bool = True,
        tuner_seed: int = 0x9E3779B97F4A7C15,
    ):
        self.config = config
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        self.devices = list(devices) if devices is not None else jax.devices()[: config.chips]
        self.n = len(self.devices)
        self.reference_banding = reference_banding
        h = config.height
        # initial split: equal rows, remainder to device 0 (ray_trace.cpp:74-81)
        base = h // self.n
        self.rows: List[int] = [base + (h - base * self.n if i == 0 else 0) for i in range(self.n)]
        self.tuner = make_tuner(h, self.n, tuner_seed)
        ds = prepare_scene(self.scene)
        self.backend = resolve_backend(config.backend, ds)
        self.device_scenes = [jax.device_put(ds, d) for d in self.devices]
        self.vp = viewport_arrays(config_camera(config), config.width, config.height)
        self.device_vps = [jax.device_put(self.vp, d) for d in self.devices]
        self.pixels_per_lane = default_pixels_per_lane(
            config, config.width * h // max(self.n, 1))

    def set_scene(self, scene: SceneArrays) -> None:
        """Swap the scene (animation: a new `generate_random_scene(t)` per
        frame, ray_trace.cpp:665 scene_time).  Re-prepares device tables on
        every device; band split and tuner state are kept — the reference
        likewise animates without resetting its tuner history."""
        self.scene = scene
        ds = prepare_scene(scene)
        self.backend = resolve_backend(self.config.backend, ds)
        self.device_scenes = [jax.device_put(ds, d) for d in self.devices]

    def set_camera(self, config: RenderConfig) -> None:
        """Adopt a config with a new camera (viewer steering input); rebuilds
        the viewport arrays on every device."""
        self.config = config
        cam = config_camera(config)
        self.vp = viewport_arrays(cam, config.width, config.height)
        self.device_vps = [jax.device_put(self.vp, d) for d in self.devices]

    def _offsets(self) -> List[int]:
        out, acc = [], 0
        for r in self.rows:
            out.append(acc)
            acc += r
        return out

    def render_frame(self, spp: int, number: int = 0):
        """Dispatch one frame across devices; returns (accum [H,W,3] np,
        frame_seconds, per-device seconds)."""
        cfg = self.config
        offs = self._offsets()
        t0 = time.perf_counter()
        futs = []
        for i, dev in enumerate(self.devices):
            if self.rows[i] == 0:
                futs.append(None)
                continue
            futs.append(
                render_band(
                    self.device_scenes[i],
                    self.device_vps[i],
                    band_h=self.rows[i],
                    width=cfg.width,
                    y0=np.int32(offs[i]),
                    seed_y0=np.int32(0 if self.reference_banding else offs[i]),
                    offset_x=np.int32(0),
                    spp=np.int32(spp),
                    number=np.uint32(number),
                    max_depth=cfg.max_depth,
                    backend=self.backend,
                    pixels_per_lane=min(self.pixels_per_lane, max(1, self.rows[i] * cfg.width)),
                    rr=cfg.rr,
                )
            )
        # fetch bands concurrently (one thread per device) so per_dev[i]
        # reflects device i's own completion time, not the fetch order —
        # matching the reference's per-device-parallel acquire-present probe
        # (ray_trace.cpp:609-644 under std::execution::par_unseq). A serial
        # fetch loop would inflate device i's estimate to include waiting on
        # devices 0..i-1 and the tuner's variance trigger would never fire.
        per_dev = [0.0] * self.n
        bands = [None] * self.n

        def _fetch(i, f):
            bands[i] = np.asarray(f)  # blocks until device i is done
            per_dev[i] = time.perf_counter() - t0

        threads = [
            threading.Thread(target=_fetch, args=(i, f))
            for i, f in enumerate(futs)
            if f is not None
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        frame_s = time.perf_counter() - t0
        accum = np.concatenate([b for b in bands if b is not None], axis=0)
        return accum, frame_s, per_dev

    def tune_round(self, spp: int, frames: int = 3, number: int = 0):
        """Render ``frames`` frames, feed the tuner, maybe adopt a new split.

        Returns (accum of last frame, duration_per_frame, new_rows or None).
        Mirrors the reference's measurement-window semantics
        (ray_trace.cpp:741-776).
        """
        total_s = 0.0
        accum = None
        per_dev = [0.0] * self.n
        for _ in range(frames):
            accum, frame_s, pd = self.render_frame(spp, number)
            total_s += frame_s
            per_dev = [a + b for a, b in zip(per_dev, pd)]
        dpf = total_s / frames
        self.tuner.add_frame(list(self.rows), dpf, per_dev)
        new = self.tuner.get_workload()
        if new is not None and any(n_ != o for n_, o in zip(new, self.rows)):
            self.rows = list(new)
        else:
            new = None
        return accum, dpf, new

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        accum, _, _ = self.render_frame(samples or self.config.samples)
        return np.asarray(imageops.accum_to_u8(accum, samples or self.config.samples))
