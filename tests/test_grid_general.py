"""Grid backends on general scenes: varied heights, textured field spheres,
many large spheres, crowded cells, and the ``auto`` routing.

Every scene renders BIT-IDENTICALLY to ``bruteforce`` through the grid
kernel (interpret mode), in exact and fast mode and across progressive
calls.
"""

import numpy as np
import pytest

from raytrace_tpu.models.grid import (DELTA, G_YHI, G_YLO, MAX_GLOBALS,
                                      build_grid)
from raytrace_tpu.models.scene import (CHECKERED, generate_random_scene,
                                       random_sphere_field,
                                       three_sphere_scene)
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera, resolve_backend

W, H = 48, 27
RR = (1, 4, 0.05)


def _render(ds, backend, *, depth=5, spp=2, m=2, rr=None, number=0,
            accum=None):
    vp = viewport_arrays(reference_camera(), W, H)
    return np.asarray(render_band(
        ds, vp, band_h=H, width=W, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(spp), number=np.uint32(number),
        accum_init=accum, max_depth=depth, backend=backend,
        pixels_per_lane=m, rr=rr, interpret=backend == "grid"))


def _varied():
    return random_sphere_field(60, seed=3, extent=8.0, y_range=(0.2, 2.5))


def _textured():
    sc = random_sphere_field(60, seed=3, extent=8.0)
    sc.texture[10:20] = CHECKERED
    sc.color1[10:20] = (0.9, 0.1, 0.1)
    return sc


def _with_extra_globals(n_extra):
    """40-sphere field + the 4 heroes + n_extra more large spheres."""
    sc = random_sphere_field(40, seed=5, extent=6.0)
    lo, hi = 44, 44 + n_extra
    sc.centers[lo:hi, 0] = np.linspace(-5.0, 5.0, n_extra)
    sc.centers[lo:hi, 1] = 1.0
    sc.centers[lo:hi, 2] = -4.0
    sc.radii[lo:hi] = 0.9
    sc.color0[lo:hi] = (0.6, 0.5, 0.4)
    return sc._replace(n_spheres=np.int32(hi))


def _crowded():
    """Six small spheres stacked vertically in one cell."""
    sc = random_sphere_field(6, seed=0, extent=4.0)
    sc.centers[4:10, 0] = 0.3
    sc.centers[4:10, 2] = 0.3
    sc.centers[4:10, 1] = 0.15 + 0.3 * np.arange(6, dtype=np.float32)
    sc.radii[4:10] = 0.1
    return sc


SCENES = {
    "varied_height": _varied,
    "textured_field": _textured,
    "many_large": lambda: _with_extra_globals(MAX_GLOBALS - 4),
    "crowded_cell": _crowded,
}


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_grid_kernel_bit_identical(scene, mode):
    ds = prepare_scene(SCENES[scene]())
    assert ds.grid is not None
    rr = RR if mode == "fast" else None
    a = _render(ds, "bruteforce", rr=rr)
    b = _render(ds, "grid", rr=rr)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_grid_kernel_progressive_bit_identical(scene):
    """A second progressive call adds onto the carried accumulator in
    place, exactly as bruteforce does."""
    ds = prepare_scene(SCENES[scene]())
    out = {}
    for backend in ("bruteforce", "grid"):
        one = _render(ds, backend, m=3)
        out[backend] = _render(ds, backend, m=3, number=1, accum=one)
    assert np.array_equal(out["bruteforce"], out["grid"])


def test_builder_varied_height():
    sc = _varied()
    g = build_grid(sc)
    assert g is not None
    # the y slab spans the field's heights (cells are clipped y-columns),
    # enlarged by DELTA like the cell registration
    cy, r = sc.centers[4:64, 1], sc.radii[4:64]
    assert g.gscal[G_YLO] == np.float32((cy - r).min() - np.float32(DELTA))
    assert g.gscal[G_YHI] == np.float32((cy + r).max() + np.float32(DELTA))


def test_builder_adaptive_slots_crowded_cell():
    """The slot count is the worst cell's occupancy."""
    g = build_grid(_crowded())
    assert g is not None and g.cellid.shape[1] == 6
    assert g.cellcnt.max() == 6


def test_many_large_spheres_build():
    """EXACTLY MAX_GLOBALS large spheres ride the globals table."""
    g = build_grid(_with_extra_globals(MAX_GLOBALS - 4))
    assert g is not None and g.gtab.shape[0] == MAX_GLOBALS


def test_too_many_large_spheres_falls_back():
    """One past the cap must fall back to brute force."""
    assert build_grid(_with_extra_globals(MAX_GLOBALS - 3)) is None


@pytest.mark.parametrize("platform,scene,expected", [
    ("gpu", "book", "grid"),
    ("gpu", "three_sphere", "matmul"),
    ("cpu", "book", "matmul"),
    ("cpu", "three_sphere", "matmul"),
])
def test_auto_backend_routing(platform, scene, expected):
    """auto: the grid kernel on the GPU whenever the scene builds a grid;
    brute force otherwise, and on the CPU (no compiled kernel there)."""
    sc = generate_random_scene(0.0) if scene == "book" else three_sphere_scene()
    assert resolve_backend("auto", prepare_scene(sc), platform=platform) \
        == expected


def test_auto_backend_reads_live_platform(monkeypatch):
    import jax

    ds = prepare_scene(generate_random_scene(0.0))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend("auto", ds) == "grid"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert resolve_backend("auto", ds) == "matmul"


@pytest.mark.parametrize("backend", ["mega", "paged", "pallas", "gridxla"])
def test_removed_backends_raise(backend):
    ds = prepare_scene(three_sphere_scene())
    with pytest.raises(ValueError, match="removed"):
        resolve_backend(backend, ds)


def test_grid_backend_needs_grid():
    ds = prepare_scene(three_sphere_scene())
    with pytest.raises(ValueError, match="grid"):
        resolve_backend("grid", ds)


def test_sharded_varied_height_backend(interpret_kernel):
    """The grid kernel composes with shard_map row bands: the 4-device
    render equals the single-device one bit for bit (global seeds)."""
    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.parallel.sharding import MultiChipRenderer
    from raytrace_tpu.runtime.renderer import Renderer

    sc = random_sphere_field(40, seed=3, extent=6.0, y_range=(0.2, 2.0))
    cfg = RenderConfig(samples=2, width=32, height=16, max_depth=5,
                       backend="grid", chips=4, pixels_per_lane=2)
    single, _ = Renderer(cfg, scene=sc).render(2)
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(2)
    assert np.array_equal(np.asarray(single), np.asarray(multi))
