"""Single-device render orchestrator — the device analogue of L4.

Replaces the per-GPU resource fan-out + frame loop of
``ray_trace_with_physical_devices`` (/root/reference/src/ray_trace.cpp:42-920).
What remains of L4 on an XLA device is (a) memory-driven row-band chunking
of the pixel grid (one jit call per band — the analogue of one
``traceRaysKHR`` dispatch), (b) the progressive multi-call accumulation path
the reference's design anticipates but neuters (quirk Q3: binding 3 +
``RenderCallInfo.number``), and (c) the frame loop with
``duration_per_frame`` timing (ray_trace.cpp:576,741-748).

Internal chunking is seed-transparent: chunks seed from *global* pixel
coordinates, so any chunk_rows setting produces bit-identical output to an
unchunked render (unlike reference multi-GPU banding, which reseeds per band —
that behavior lives in ``parallel/sharding.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops.trace import (BACKENDS, DeviceScene, lane_count, prepare_scene,
                         render_band, viewport_arrays)

# Brute-force backends materialise [lanes, spheres] intermediates
# (bruteforce: [lanes, spheres, 3]); a band holds at most this many
# elements per intermediate, so dense scenes get fewer lanes per band.
_PAIR_BUDGET = {"matmul": 1 << 28, "bruteforce": 1 << 23}
REMOVED_BACKENDS = ("mega", "paged", "pallas", "gridxla")


def reference_camera() -> Camera:
    """Fixed camera of the reference frame loop (ray_trace.cpp:669-670, Q4):
    pos (13,11,-3) looking at the origin; fov/aperture/focus baked in rgen."""
    return Camera(look_from=(13.0, 11.0, -3.0), look_at=(0.0, 0.0, 0.0))


def config_camera(config: RenderConfig) -> Camera:
    """Camera from config overrides (RenderCallInfo.camera_pos/camera_dir
    semantics: lookAt = pos + dir, shader.rgen:48-49) or the reference's."""
    if config.camera_pos is None and config.camera_dir is None:
        return reference_camera()
    pos = config.camera_pos if config.camera_pos is not None else (13.0, 11.0, -3.0)
    d = config.camera_dir if config.camera_dir is not None else (-pos[0], -pos[1], -pos[2])
    return Camera(look_from=tuple(pos),
                  look_at=(pos[0] + d[0], pos[1] + d[1], pos[2] + d[2]))


def resolve_backend(requested: str, device_scene: DeviceScene,
                    platform: Optional[str] = None) -> str:
    """Backend for a scene.  ``auto`` takes the grid kernel on the GPU for
    every scene that builds a grid, and ``matmul`` otherwise (scenes
    without a grid, and the CPU, where the kernel has no compiled form).
    Explicit backends are honoured; a grid backend on a scene without a
    grid, or a removed backend, raises."""
    if requested in REMOVED_BACKENDS:
        raise ValueError(f"backend {requested!r} was removed; use one of "
                         f"auto|{'|'.join(BACKENDS)}")
    if requested == "auto":
        platform = platform or jax.default_backend()
        if platform == "gpu" and device_scene.grid is not None:
            return "grid"
        return "matmul"
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend: {requested!r}")
    if requested == "grid" and device_scene.grid is None:
        raise ValueError(f"backend {requested!r} needs a scene that builds "
                         "a grid (models/grid.py)")
    return requested


def default_pixels_per_lane(config: RenderConfig, pixels: int) -> int:
    """Wavefront M for ``pixels`` pixels: the device profile's lane target
    (runtime/chips.py) unless the config pins it.  Output is bit-identical
    for every M (tests pin it); M only moves speed."""
    if config.pixels_per_lane is not None:
        return config.pixels_per_lane
    from .chips import profile_for

    prof = profile_for()
    return int(np.clip(pixels // prof.lanes_target, 1, prof.m_max))


def band_rows(backend: str, n_spheres: int, width: int, height: int,
              pixels_per_lane: int) -> int:
    """Rows per band: the whole frame for the grid kernel (no
    [lanes, spheres] intermediates); brute force bounds lanes x spheres by
    _PAIR_BUDGET so dense scenes fit the device."""
    budget = _PAIR_BUDGET.get(backend)
    if budget is None:
        return height
    lanes = max(256, budget // max(n_spheres, 1))
    return max(1, min(height, lanes * pixels_per_lane // max(width, 1)))


class Renderer:
    """Renders full frames for one logical device (one band = one jit call)."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None):
        self.config = config
        w, h = config.width, config.height
        self.pixels_per_lane = default_pixels_per_lane(config, w * h)
        self.set_scene(scene if scene is not None
                       else generate_random_scene(config.scene_time))
        self.vp = jax.device_put(viewport_arrays(config_camera(config), w, h))

    def set_scene(self, scene: SceneArrays) -> None:
        """Adopt a scene: device tables, backend, and band height (brute
        force bands shrink as the sphere count grows)."""
        cfg = self.config
        self.scene = scene
        # device residency: one device_put here makes every later
        # render_call transfer only its scalars
        self.device_scene: DeviceScene = jax.device_put(prepare_scene(scene))
        self.backend = resolve_backend(cfg.backend, self.device_scene)
        self.chunk_rows = band_rows(self.backend,
                                    self.device_scene.centers.shape[0],
                                    cfg.width, cfg.height,
                                    self.pixels_per_lane)

    def render_call(self, spp: int, number: int = 0, accum=None,
                    return_iters: bool = False):
        """One render call (= one traceRaysKHR dispatch): spp samples/pixel.

        Returns the accumulated color sum [H, W, 3] (device array, pre-gamma).
        ``accum`` carries the running sum for progressive rendering.
        ``return_iters``: also return the wavefront iteration count summed
        over bands.
        """
        cfg = self.config
        w, h = cfg.width, cfg.height
        bands = []
        iters = 0
        for band_y0 in range(0, h, self.chunk_rows):
            band_h = min(self.chunk_rows, h - band_y0)
            init = None if accum is None else accum[band_y0 : band_y0 + band_h]
            out = render_band(
                self.device_scene,
                self.vp,
                band_h=band_h,
                width=w,
                y0=np.int32(band_y0),
                seed_y0=np.int32(band_y0),  # global coords: chunk-invariant
                offset_x=np.int32(0),
                spp=np.int32(spp),
                number=np.uint32(number),
                accum_init=init,
                max_depth=cfg.max_depth,
                backend=self.backend,
                pixels_per_lane=self.pixels_per_lane,
                rr=cfg.rr,
                return_iters=return_iters,
            )
            if return_iters:
                out, it = out
                iters += int(it)
            bands.append(out)
        acc = bands[0] if len(bands) == 1 else jnp.concatenate(bands, axis=0)
        if return_iters:
            return acc, iters
        return acc

    def render(self, samples: Optional[int] = None, on_chunk=None):
        """Full render: ``samples`` total spp, split into progressive calls of
        ``config.samples_per_call`` (reference runs everything in one call,
        quirk Q3).  Returns (accum_sum [H,W,3], total_spp).

        ``on_chunk(accum, samples_done)`` fires after each progressive call —
        the headless analogue of the reference's live window updating every
        frame (the CLI's --preview writes the running PNG from it).

        accum_dtype="float64" reproduces the reference's dvec3 accumulation
        semantics (shader.rgen:55, quirk Q5): each call's f32 chunk sum is
        added into a float64 host accumulator (the f64 adds happen host-side
        across calls — in-chunk summation stays device f32).
        """
        cfg = self.config
        total = cfg.samples if samples is None else samples
        per_call = cfg.samples_per_call or total
        number = 0
        done = 0
        if cfg.accum_dtype == "float64":
            accum64: Optional[np.ndarray] = None
            while done < total:
                spp = min(per_call, total - done)
                chunk = np.asarray(self.render_call(spp, number=number), np.float64)
                accum64 = chunk if accum64 is None else accum64 + chunk
                done += spp
                number += 1
                if on_chunk is not None:
                    on_chunk(accum64, done)
            return accum64, total
        if cfg.accum_dtype != "float32":
            raise ValueError(f"unsupported accum_dtype: {cfg.accum_dtype!r}")
        accum = None
        while done < total:
            step = min(per_call, total - done)
            accum = self.render_call(step, number=number, accum=accum)
            done += step
            number += 1
            if on_chunk is not None:
                on_chunk(accum, done)
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        """Render and tonemap to the display image (u8 RGB, host array)."""
        accum, total = self.render(samples)
        return np.asarray(imageops.accum_to_u8(accum, total))

    def save_state(self, path: str, accum, samples_done: int, number: int) -> None:
        """Checkpoint a progressive render (accumulator + progress).

        The reference has no checkpointing (its accumulator is cleared every
        frame, quirk Q3); this completes the progressive design it implies.
        """
        np.savez(
            path, accum=np.asarray(accum), samples_done=samples_done,
            number=number, width=self.config.width, height=self.config.height,
        )

    def load_state(self, path: str):
        """Returns (accum, samples_done, number) for resuming ``render``."""
        z = np.load(path)
        if (int(z["width"]), int(z["height"])) != (self.config.width, self.config.height):
            raise ValueError("checkpoint resolution mismatch")
        return z["accum"], int(z["samples_done"]), int(z["number"])

    def render_resumable(self, total: int, checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 0, max_retries: int = 2):
        """Progressive render with checkpoint/resume + device-fault retry.

        Failure recovery the reference lacks (SURVEY.md §5: its errors just
        throw to main): each call's accumulator is snapshotted to host, so a
        device runtime fault loses at most one call's work; the render
        resumes automatically.
        """
        cfg = self.config
        if checkpoint_every:
            per_call = cfg.samples_per_call or max(1, checkpoint_every)
        else:
            per_call = cfg.samples_per_call or total
        accum, done, number = None, 0, 0
        if checkpoint_path:
            import os

            if os.path.exists(checkpoint_path):
                accum, done, number = self.load_state(checkpoint_path)
        retries = 0
        while done < total:
            spp = min(per_call, total - done)
            try:
                out = self.render_call(spp, number=number, accum=accum)
                out = np.asarray(out)  # host snapshot; also a real sync point
            except Exception:
                if retries >= max_retries:
                    raise
                retries += 1
                continue  # accum (host array) is intact; retry the call
            accum, done, number = out, done + spp, number + 1
            if checkpoint_path and checkpoint_every and done < total:
                self.save_state(checkpoint_path, accum, done, number)
        return accum, done

    def benchmark(self, min_seconds: float = 4.0, warmup: int = 1):
        """Frame-loop benchmark with the reference's adaptive measurement
        window: duration_per_frame over >= (4 s + 50 dpf)/dpf frames
        (ray_trace.cpp:86,741-748).  Returns (dpf_seconds, frames)."""
        spp = self.config.samples
        # np.asarray fetches each frame to the host, so the timing covers
        # the whole device execution
        for _ in range(warmup):
            np.asarray(self.render_call(spp))
        # first probe frame
        t0 = time.perf_counter()
        np.asarray(self.render_call(spp))
        dpf = time.perf_counter() - t0
        frames = max(1, int((min_seconds + 50.0 * dpf) / dpf)) if dpf > 0 else 1
        frames = min(frames, 1000)
        t0 = time.perf_counter()
        for _ in range(frames):
            np.asarray(self.render_call(spp))
        dpf = (time.perf_counter() - t0) / frames
        print(f"duration_per_frame: {dpf * 1000.0:.3f} ms")
        return dpf, frames
