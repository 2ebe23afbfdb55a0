"""Persistent-wavefront path-tracing core — the device `traceRaysKHR`.

This module replaces the entire Vulkan RT pipeline of the reference
(/root/reference/shaders/shader.rgen + rint + rchit + rmiss dispatched by
``traceRaysKHR`` at /root/reference/src/vulkan.h:994) with ONE jitted loop.

Design ("persistent wavefront with M-pixel lanes"): each lane owns M
strided pixels (slot m of lane k is band pixel m * n_lanes + k) and renders
their samples back-to-back.  Each iteration traces one ray segment per lane
(closest hit -> shade -> scatter).  When a lane's path terminates (sky miss,
metal absorb, depth 50) its contribution joins the running sum of the
lane's pixel and the lane immediately regenerates the pixel's next sample,
or flushes the sum and moves to its next pixel — so shapes stay static and
lanes stay busy.  The step itself lives in ops/wavefront.py and is shared by
every backend; the backends differ only in the closest-hit search:

  ``grid``        uniform-grid DDA (models/grid.py) as one Pallas-Triton
                  kernel: lane state stays in registers for the whole band
                  (ops/gridkernel.py) — the GPU hot path;
  ``matmul``      brute force over all spheres with the two ray x sphere
                  contractions as matrix products (ops/intersect.py);
  ``bruteforce``  brute force in the oracle's exact fp op order — the
                  parity reference for tests.

The RNG semantics are the reference's: GLSL runs all samples of a pixel
sequentially on one thread with one carried LCG seed (shader.rgen:40,56-60);
here each lane carries that seed through bounce -> termination ->
regeneration, so ``bruteforce`` reproduces the oracle/GLSL draw stream and
images validate near-bitwise (SURVEY.md §7 hard-part (b)).

Seed/uv coordinate conventions (multi-GPU parity): the reference seeds from
*launch-local* coordinates but computes uv from ``offset + launch``
(shader.rgen:40,45).  ``render_band`` therefore takes both a uv row origin
(``y0``, the band's global row) and a seed row origin (``seed_y0``): internal
memory-chunking passes ``seed_y0 = y0`` (identical to a single-GPU reference
render), while the multi-device layer may pass ``seed_y0 = 0`` to mirror the
reference's per-GPU banding.
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_DEPTH, MAX_RAY_COLLISION_DISTANCE, T_MIN
from ..models.camera import Camera, calculate_viewport
from ..models.scene import SceneArrays
from . import wavefront as wf
from .intersect import intersect_bruteforce, intersect_matmul, sphere_constants

BACKENDS = ("grid", "matmul", "bruteforce")


class DeviceScene(NamedTuple):
    """Scene data prepared for the device (a pytree of arrays).

    ``centers_t``/``kc`` are the matmul-path precomputes (intersect.py);
    ``valid`` masks the MAX_SPHERE_AMOUNT padding (scene.h:24-28);
    ``atab`` holds the per-sphere shading attributes every backend reads
    (wavefront.attr_table).
    """

    centers: jnp.ndarray  # [S,3] f32
    centers_t: jnp.ndarray  # [3,S] f32
    radii: jnp.ndarray  # [S] f32
    kc: jnp.ndarray  # [S] f32 = |c|^2 - r^2 (f64 precompute)
    valid: jnp.ndarray  # [S] bool
    atab: jnp.ndarray  # [S, wavefront.A_COLS] f32
    grid: object = None  # models.grid.GridTables, or None when the scene
    #                      does not fit the uniform grid


class ViewportArrays(NamedTuple):
    """Viewport constants as arrays (dynamic jit args — no recompiles when the
    camera animates)."""

    horizontal: jnp.ndarray  # [3]
    vertical: jnp.ndarray  # [3]
    upper_left: jnp.ndarray  # [3]
    cam_up: jnp.ndarray  # [3]
    cam_right: jnp.ndarray  # [3]
    look_from: jnp.ndarray  # [3]
    aperture: jnp.ndarray  # [] f32
    size: jnp.ndarray  # [2] f32 (width, height) — shader.rgen:42


def prepare_scene(scene: SceneArrays, grid_pitch=None) -> DeviceScene:
    """Host-side scene prep: SoA -> device layout (host numpy tables).

    ``grid_pitch``: grid cell size in world units, or None for the
    choice of models/grid.py build_grid.
    """
    from ..models.grid import build_grid

    centers = np.asarray(scene.centers, np.float32)
    radii = np.asarray(scene.radii, np.float32)
    valid = np.arange(centers.shape[0]) < int(scene.n_spheres)
    return DeviceScene(
        centers=centers,
        centers_t=np.ascontiguousarray(centers.T),
        radii=radii,
        kc=sphere_constants(centers, radii),
        valid=valid,
        atab=wf.attr_table(scene),
        grid=build_grid(scene, pitch=grid_pitch),
    )


def viewport_arrays(camera: Camera, width: int, height: int) -> ViewportArrays:
    """Precompute calculateViewport (shader.rgen:92-105) once on the host."""
    vp = calculate_viewport(camera, np.float32(width) / np.float32(height))
    return ViewportArrays(
        horizontal=vp.horizontal,
        vertical=vp.vertical,
        upper_left=vp.upper_left_corner,
        cam_up=vp.camera_up,
        cam_right=vp.camera_right,
        look_from=vp.look_from,
        aperture=np.float32(vp.aperture),
        size=np.array([width, height], np.float32),
    )


def lane_count(p_total: int, pixels_per_lane: int):
    """(M, lanes) for a band of ``p_total`` pixels: M strided pixels per
    lane, capped at the pixel count."""
    m_slots = max(1, min(pixels_per_lane, p_total))
    return m_slots, -(-p_total // m_slots)


def _closest_hit(backend, scene: DeviceScene, st: wf.Lanes):
    """Brute-force closest hit of every lane: (t, idx, hit, done)."""
    o = jnp.stack([st.ox, st.oy, st.oz], axis=1)
    d = jnp.stack([st.dx, st.dy, st.dz], axis=1)
    tmin = jnp.float32(T_MIN)
    tmax = jnp.float32(MAX_RAY_COLLISION_DISTANCE)
    if backend == "bruteforce":
        t, idx, hit = intersect_bruteforce(o, d, scene.centers, scene.radii,
                                           scene.valid, tmin, tmax)
    else:
        t, idx, hit = intersect_matmul(o, d, scene.centers_t, scene.kc,
                                       scene.valid, tmin, tmax)
    return t, idx, hit, st.alive != 0


def _render_xla(scene: DeviceScene, scal, vpr, acc, *, backend, n_lanes,
                m_slots, p_total, width, max_depth, rr):
    """The brute-force wavefront as an XLA while loop over all lanes of the
    band."""
    lane = jnp.arange(n_lanes, dtype=jnp.int32)
    alive0 = jnp.broadcast_to(scal[wf.S_SPP] > 0, (n_lanes,))
    st0 = wf.init_lanes(lane, alive0, scal, vpr, width)

    def cond(c):
        return jnp.any(c[0].alive != 0)

    def body(c):
        st, acc, it = c
        t, idx, hit, done = _closest_hit(backend, scene, st)
        st, flush, pix, cur = wf.step(
            st, lane, t, idx, hit, done, scal=scal, vpr=vpr, atab=scene.atab,
            m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
            max_depth=max_depth, rr=rr, div=operator.truediv)
        # each pixel belongs to one lane and is flushed once: a scatter to
        # distinct indices, deterministic on every device
        acc = acc.at[:, jnp.where(flush, pix, p_total)].add(
            jnp.stack(cur), mode="drop")
        return st, acc, it + 1

    _, acc, iters = jax.lax.while_loop(cond, body, (st0, acc, jnp.int32(0)))
    return acc, iters


def render_band_core(
    scene: DeviceScene,
    vp: ViewportArrays,
    *,
    band_h: int,
    width: int,
    y0,  # global row of the band's first row (dynamic i32) — uv offset
    seed_y0,  # row origin for RNG seeding (dynamic i32); see module docstring
    offset_x,  # RenderCallInfo.offset.x (dynamic i32)
    spp,  # samples per render call (dynamic i32)
    number,  # RenderCallInfo.number (dynamic u32) — progressive call index
    accum_init=None,  # [band_h, width, 3] f32 carried accumulator, or None
    max_depth: int = MAX_DEPTH,
    backend: str = "matmul",
    pixels_per_lane: int = 1,
    return_iters: bool = False,
    rr=None,  # fast mode (static): (d0, d1, pmin) Russian-roulette params —
    # unbiased path termination past depth d0 with survival p = clamp(max
    # throughput component, pmin, 1) (halved past d1), throughput /= p on
    # survival.  None = exact reference-stream mode (the bit-parity chain).
    interpret: bool = False,  # grid: run the Pallas kernel in the
    # interpreter (tests on a machine without the card)
):
    """Render one row band; returns the accumulated color sum [band_h, W, 3].

    Implements shader.rgen main() semantics: per-pixel seed
    ``tea(tea(x, y), number)``, ``spp`` sequential jittered samples, and the
    iterative <=``max_depth`` bounce loop of calculateRayColor
    (shader.rgen:70-89) — restructured as a persistent-wavefront loop (module
    docstring).  Divide by spp and sqrt for the display image (gamma 2).

    ``pixels_per_lane`` (M): each lane renders M strided pixels in
    sequence.  Per-pixel RNG streams and results are IDENTICAL for any M
    (lane scheduling never reorders a pixel's sequential samples).
    ``return_iters`` also returns the wavefront iteration count (for
    ``grid``: the longest block's).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} "
                         f"(expected one of {'|'.join(BACKENDS)})")
    if backend == "grid" and scene.grid is None:
        raise ValueError(f"backend {backend!r} needs a scene that builds a "
                         "grid (models/grid.py)")
    scene = jax.tree.map(jnp.asarray, scene)  # host tables when unjitted
    p_total = band_h * width
    m_slots, n_lanes = lane_count(p_total, pixels_per_lane)
    scal = wf.call_scalars(spp, number, y0, seed_y0, offset_x)
    vpr = wf.viewport_vector(vp)
    if accum_init is None:
        acc = jnp.zeros((3, p_total), jnp.float32)
    else:
        acc = jnp.asarray(accum_init, jnp.float32).reshape(p_total, 3).T
    kw = dict(n_lanes=n_lanes, m_slots=m_slots, p_total=p_total, width=width,
              max_depth=max_depth, rr=rr)
    if backend == "grid":
        from .gridkernel import render_lanes

        acc, iters = render_lanes(scene.grid, scene.atab, scal, vpr, acc,
                                  interpret=interpret, **kw)
        iters = jnp.max(iters)
    else:
        acc, iters = _render_xla(scene, scal, vpr, acc, backend=backend, **kw)
    acc = acc.T.reshape(band_h, width, 3)
    if return_iters:
        return acc, iters
    return acc


render_band = jax.jit(
    render_band_core,
    static_argnames=(
        "band_h", "width", "max_depth", "backend", "pixels_per_lane",
        "return_iters", "rr", "interpret",
    ),
)
