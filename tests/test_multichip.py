"""Multi-chip row-band sharding tests on the virtual 8-device CPU mesh.

Mirrors the reference's multi-GPU split (SURVEY.md §2 parallelism table):
band-split render must assemble to the single-device image."""

import jax
import numpy as np
import pytest

from raytrace_tpu.config import RenderConfig


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Serializing the large 8-device shard_map CPU executables for the
    persistent cache segfaults intermittently on this jaxlib (PJRT CPU AOT
    `executable.serialize()`, cross-machine feature-mismatch class — it
    killed two full-suite runs at exactly these tests).  They compile in
    seconds, so skip the cache here entirely."""
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
from raytrace_tpu.models.scene import three_sphere_scene
from raytrace_tpu.parallel.sharding import MultiChipRenderer, make_mesh
from raytrace_tpu.runtime.renderer import Renderer

W, H, SPP = 32, 24, 4


@pytest.fixture(scope="module")
def config():
    return RenderConfig(samples=SPP, width=W, height=H, max_depth=8, backend="matmul", chips=8)


@pytest.fixture(scope="module")
def scene():
    return three_sphere_scene()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_equals_single_chip(config, scene):
    """Global-seed mode: N-device render is bit-identical to 1-device."""
    single, _ = Renderer(config, scene=scene).render(SPP)
    multi, _ = MultiChipRenderer(config, scene=scene).render(SPP)
    assert np.array_equal(np.asarray(single), np.asarray(multi))


def test_reference_banding_statistical(config, scene):
    """Reference-banding mode reseeds per band (different stream, same image
    statistics) — mirrors the reference's per-GPU launches."""
    single, _ = Renderer(config, scene=scene).render(SPP)
    multi, _ = MultiChipRenderer(config, scene=scene, reference_banding=True).render(SPP)
    single, multi = np.asarray(single), np.asarray(multi)
    assert not np.array_equal(single, multi)
    assert abs(single.mean() - multi.mean()) / single.mean() < 0.1


def test_unpadded_height():
    """Height not divisible by device count: padded internally, cropped out."""
    cfg = RenderConfig(samples=2, width=16, height=13, max_depth=6, backend="matmul", chips=8)
    sc = three_sphere_scene()
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(2)
    single, _ = Renderer(cfg, scene=sc).render(2)
    assert multi.shape == (13, 16, 3)
    assert np.array_equal(np.asarray(single), np.asarray(multi))


def test_make_mesh():
    mesh = make_mesh(4)
    assert mesh.devices.size == 4
    with pytest.raises(ValueError):
        make_mesh(99)


def test_sharded_bruteforce_backend():
    """The oracle-order backend composes with shard_map too."""
    cfg = RenderConfig(samples=2, width=32, height=16, max_depth=6,
                       backend="bruteforce", chips=4, pixels_per_lane=2)
    sc = three_sphere_scene()
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(2)
    single, _ = Renderer(cfg, scene=sc).render(2)
    assert np.array_equal(np.asarray(single), np.asarray(multi))


def test_sharded_dense_grid_backend(interpret_kernel):
    """BASELINE config 5's shape: a dense sphere field on the grid kernel,
    row-band-split across the mesh, bit-identical to one device."""
    from raytrace_tpu.models.scene import random_sphere_field

    cfg = RenderConfig(samples=2, width=32, height=16, max_depth=5,
                       backend="grid", chips=4, pixels_per_lane=2)
    sc = random_sphere_field(2000, seed=1, extent=7.0)
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(2)
    single, _ = Renderer(cfg, scene=sc).render(2)
    assert np.array_equal(np.asarray(single), np.asarray(multi))


@pytest.mark.parametrize("chips", [4, 8])
def test_sharded_grid_backend(chips, interpret_kernel):
    """The grid kernel composes with shard_map row bands on 4 and on all 8
    devices; the book scene is the grid's own regime."""
    from raytrace_tpu.models.scene import generate_random_scene

    cfg = RenderConfig(samples=2, width=32, height=16, max_depth=5,
                       backend="grid", chips=chips, pixels_per_lane=2)
    sc = generate_random_scene(0.0)
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(2)
    single, _ = Renderer(cfg, scene=sc).render(2)
    assert np.array_equal(np.asarray(single), np.asarray(multi))


def test_sharded_grid_bit_identical_matched_bands(interpret_kernel):
    """A single-device render chunked at the SAME band height with global
    seeds runs the identical per-band program as each device of the
    N-device render."""
    from raytrace_tpu.models.scene import generate_random_scene
    from raytrace_tpu.ops.trace import (prepare_scene, render_band,
                                        viewport_arrays)
    from raytrace_tpu.runtime.renderer import reference_camera

    W_, H_, SPP_, CHIPS = 32, 16, 2, 4
    sc = generate_random_scene(0.0)
    cfg = RenderConfig(samples=SPP_, width=W_, height=H_, max_depth=5,
                       backend="grid", chips=CHIPS, pixels_per_lane=2)
    multi, _ = MultiChipRenderer(cfg, scene=sc).render(SPP_)
    ds = prepare_scene(sc)
    vp = viewport_arrays(reference_camera(), W_, H_)
    bh = H_ // CHIPS
    bands = [
        np.asarray(render_band(
            ds, vp, band_h=bh, width=W_, y0=np.int32(y0), seed_y0=np.int32(y0),
            offset_x=np.int32(0), spp=np.int32(SPP_), number=np.uint32(0),
            max_depth=5, backend="grid", pixels_per_lane=2, interpret=True))
        for y0 in range(0, H_, bh)
    ]
    assert np.array_equal(np.concatenate(bands, axis=0), np.asarray(multi))


def test_bandsplit_check_runs(interpret_kernel):
    """chip_smoke.py's band-split check (runtime/validation.py) passes on
    the CPU with the kernel in interpret mode."""
    from raytrace_tpu.runtime.validation import bandsplit_check

    res = bandsplit_check(n_bands=4)
    assert res["total_px"] == 128 * 72
    assert res["ok"], res
