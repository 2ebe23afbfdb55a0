"""Multi-chip data parallelism: row-band split over a device mesh.

The replacement for the reference's multi-GPU spatial data parallelism
(/root/reference/src/ray_trace.cpp:74-105): the image is split into horizontal
row bands, one per device, with the scene replicated — exactly the reference's
scheme, but expressed as ``shard_map`` over a 1-D ``jax.sharding.Mesh`` instead
of per-GPU Vulkan resource arrays.  The reference composites bands by placing
borderless windows edge-to-edge (window.hpp:47-54 — the GPUs never exchange
data); here the single sharded output array plays that role, and the only
"collective" in the system is fetching it to the host.

Seed semantics (``reference_banding``):
- ``False`` (default): every band seeds from global pixel rows, so an
  N-device render is bit-identical to the single-device render — the
  default, and what the multichip test asserts.
- ``True``: bands seed from band-local rows like the reference's per-GPU
  launches (shader.rgen:40 with per-device offset at :45), reproducing the
  reference's multi-GPU RNG layout (statistically identical images).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops.trace import prepare_scene, render_band_core, viewport_arrays
from ..runtime.renderer import (config_camera, default_pixels_per_lane,
                                resolve_backend)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), axis_names=("band",))


class MultiChipRenderer:
    """Renders row bands across a 1-D mesh, one band per device (every
    device reaches every other at the same rate, so the mesh follows the
    row split alone)."""

    def __init__(
        self,
        config: RenderConfig,
        scene: Optional[SceneArrays] = None,
        mesh: Optional[Mesh] = None,
        reference_banding: bool = False,
    ):
        self.config = config
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        self.device_scene = prepare_scene(self.scene)
        self.backend = resolve_backend(config.backend, self.device_scene)
        self.mesh = mesh if mesh is not None else make_mesh(min(config.chips, len(jax.devices())))
        self.n = self.mesh.devices.size
        self.reference_banding = reference_banding
        w, h = config.width, config.height
        if h % self.n:
            # pad render height to a multiple of the band count; extra rows are
            # rendered (cheap) and cropped — keeps shard shapes equal.
            self.padded_h = (h // self.n + 1) * self.n
        else:
            self.padded_h = h
        self.band_h = self.padded_h // self.n
        self.pixels_per_lane = default_pixels_per_lane(config,
                                                       w * self.band_h)
        self.vp = viewport_arrays(config_camera(config), w, h)

        self._compiled = {}  # has_accum -> jitted shard_map fn

    def _fn(self, has_accum: bool):
        """Build (once) the jitted sharded render step; spp/number dynamic."""
        if has_accum in self._compiled:
            return self._compiled[has_accum]
        cfg = self.config
        w, band_h = cfg.width, self.band_h
        ref_banding = self.reference_banding
        backend, max_depth = self.backend, cfg.max_depth
        ppl = self.pixels_per_lane

        def band_fn(scene, vp, spp, number, accum_band):
            i = jax.lax.axis_index("band")
            y0 = (i * band_h).astype(jnp.int32)
            seed_y0 = jnp.int32(0) if ref_banding else y0
            return render_band_core(
                scene, vp, band_h=band_h, width=w, y0=y0, seed_y0=seed_y0,
                offset_x=jnp.int32(0), spp=spp, number=number,
                accum_init=accum_band, max_depth=max_depth, backend=backend,
                pixels_per_lane=ppl, rr=cfg.rr,
            )

        if has_accum:
            fn = jax.shard_map(
                band_fn, mesh=self.mesh,
                in_specs=(P(), P(), P(), P(), P("band")),
                out_specs=P("band"), check_vma=False)
        else:
            fn = jax.shard_map(
                lambda s, v, spp, num: band_fn(s, v, spp, num, None),
                mesh=self.mesh, in_specs=(P(), P(), P(), P()),
                out_specs=P("band"), check_vma=False)
        self._compiled[has_accum] = jax.jit(fn)
        return self._compiled[has_accum]

    def render_call(self, spp: int, number: int = 0, accum=None):
        """One sharded render call; returns accum sum [H, W, 3] (unpadded)."""
        cfg = self.config
        if accum is not None:
            pad = self.padded_h - cfg.height
            if pad:
                accum = jnp.concatenate(
                    [accum, jnp.zeros((pad, cfg.width, 3), jnp.float32)], axis=0
                )
            out = self._fn(True)(
                self.device_scene, self.vp, jnp.int32(spp), jnp.uint32(number), accum
            )
        else:
            out = self._fn(False)(
                self.device_scene, self.vp, jnp.int32(spp), jnp.uint32(number)
            )
        return out[: cfg.height]

    def render(self, samples: Optional[int] = None):
        cfg = self.config
        total = cfg.samples if samples is None else samples
        per_call = cfg.samples_per_call or total
        accum, number, done = None, 0, 0
        while done < total:
            spp = min(per_call, total - done)
            accum = self.render_call(spp, number=number, accum=accum)
            done += spp
            number += 1
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        accum, total = self.render(samples)
        return np.asarray(imageops.accum_to_u8(accum, total))
