"""Heterogeneous dispatch + tuner integration on the virtual CPU mesh."""

import time

import numpy as np
import pytest

from raytrace_tpu.config import RenderConfig
from raytrace_tpu.models.scene import (generate_random_scene,
                                       random_sphere_field,
                                       three_sphere_scene)
from raytrace_tpu.parallel.hetero import HeteroRenderer
from raytrace_tpu.runtime.renderer import Renderer

W, H, SPP = 32, 24, 2


def _cfg(**kw):
    kw.setdefault("samples", SPP)
    kw.setdefault("width", W)
    kw.setdefault("height", H)
    kw.setdefault("max_depth", 6)
    kw.setdefault("backend", "matmul")
    kw.setdefault("chips", 4)
    return RenderConfig(**kw)


def test_hetero_assembles_full_image():
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(), scene=sc, reference_banding=False)
    accum, frame_s, per_dev = r.render_frame(SPP)
    assert accum.shape == (H, W, 3)
    assert frame_s > 0 and len(per_dev) == 4
    # global-seed banding == single-device render, bit-exact
    single, _ = Renderer(_cfg(chips=1), scene=sc).render(SPP)
    assert np.array_equal(accum, np.asarray(single))


def test_hetero_reference_banding_differs_but_statistically_matches():
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(), scene=sc, reference_banding=True)
    accum, _, _ = r.render_frame(SPP)
    single, _ = Renderer(_cfg(chips=1), scene=sc).render(SPP)
    single = np.asarray(single)
    assert not np.array_equal(accum, single)
    assert abs(accum.mean() - single.mean()) / single.mean() < 0.15


class _SlowBand:
    """Future-like band whose host fetch takes a prescribed time."""

    def __init__(self, shape, delay):
        self._shape, self._delay = shape, delay

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay)
        return np.zeros(self._shape, np.float32 if dtype is None else dtype)


def _patch_synthetic_devices(monkeypatch, renderer, per_row_s):
    """Replace render_band with a zero-image future that 'computes' for
    rows * per_row_s[device] seconds (device identified by its y0 offset)."""
    import raytrace_tpu.parallel.hetero as hetero_mod

    def fake(*args, **kw):
        dev = renderer._offsets().index(int(kw["y0"]))
        return _SlowBand((int(kw["band_h"]), renderer.config.width, 3),
                         int(kw["band_h"]) * per_row_s[dev])

    monkeypatch.setattr(hetero_mod, "render_band", fake)


def test_probe_is_per_device_not_serialized(monkeypatch):
    """A fast device listed AFTER a slow one must still report a small busy
    time — the reference probe is per-device-parallel (ray_trace.cpp:609-644);
    a serial fetch loop would report per_dev[1] >= per_dev[0]."""
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(chips=2, height=48), scene=sc)
    _patch_synthetic_devices(monkeypatch, r, [4e-3, 1e-4])  # dev0 40x slower
    _, _, per_dev = r.render_frame(SPP)
    assert per_dev[1] < per_dev[0] / 2


def test_tuner_converges_on_2x_slow_device(monkeypatch):
    """Full loop (threaded probe -> tuner -> row re-split) rebalances toward
    the ~2:1 row split when device 1 is 2x slower per row."""
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(chips=2, height=48), scene=sc)
    _patch_synthetic_devices(monkeypatch, r, [4e-3, 8e-3])
    assert r.rows == [24, 24]
    for _ in range(60):
        r.tune_round(SPP, frames=1)
        assert sum(r.rows) == 48 and all(rr >= 1 for rr in r.rows)
    # optimum is 32:16; require clear movement toward it
    assert r.rows[0] - r.rows[1] >= 8, r.rows


SCENES = {"book": lambda: generate_random_scene(0.0),
          "dense": lambda: random_sphere_field(2000, seed=1, extent=7.0)}


@pytest.mark.parametrize("backend,scene", [("grid", "book"), ("grid", "dense")])
def test_hetero_production_backends(backend, scene, interpret_kernel):
    """The tuner path against the grid kernel (interpret mode here), not
    just matmul, on the book scene and a dense field.  Each re-split
    changes band heights (new jit cache keys) — the full reference
    teardown-rebuild analogue."""
    sc = SCENES[scene]()
    cfg = _cfg(width=48, height=24, backend=backend, chips=2, max_depth=4,
               pixels_per_lane=2)
    r = HeteroRenderer(cfg, scene=sc, reference_banding=False)
    assert r.backend == backend
    accum, _, per_dev = r.render_frame(1)
    assert accum.shape == (24, 48, 3) and len(per_dev) == 2
    single, _ = Renderer(cfg, scene=sc).render(1)
    single = np.asarray(single)
    # global seeds: the banded frame equals the single-device frame
    assert np.array_equal(accum, single)
    # force an uneven re-split and render again (new band heights compile)
    r.rows = [16, 8]
    accum2, _, _ = r.render_frame(1)
    assert np.array_equal(accum2, single)


def test_tune_round_updates_rows():
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(), scene=sc)
    rows0 = list(r.rows)
    assert sum(rows0) == H
    for _ in range(4):
        accum, dpf, new = r.tune_round(SPP, frames=1)
        assert sum(r.rows) == H
        assert dpf > 0
    # distribution stays a valid partition whatever the tuner decided
    assert all(rr >= 0 for rr in r.rows)
