"""The compiled grid kernel on the card (marker ``gpu``).

These skip without an NVIDIA GPU and run on the card through
``python chip_smoke.py``.  On the CPU the kernel runs in interpret mode and
is pinned bit for bit to ``bruteforce`` (tests/test_grid*.py); here the
Triton-compiled kernel is checked against the XLA-compiled references.
Triton and XLA contract multiply-adds into FMAs in different places, so the
cross-compiler comparisons carry a stated tolerance; comparisons of the
kernel with itself are bitwise, because a lane's arithmetic does not depend
on the band's shape, M, or the carried accumulator.
"""

import numpy as np
import pytest

from raytrace_tpu.models.scene import generate_random_scene, random_sphere_field
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime import validation
from raytrace_tpu.runtime.renderer import reference_camera, resolve_backend

pytestmark = pytest.mark.gpu

W, H = 128, 72


@pytest.fixture(scope="module")
def book():
    return prepare_scene(generate_random_scene(0.0))


def _render(ds, backend, *, m=1, y0=0, band_h=H, accum=None, number=0,
            spp=2, depth=8):
    vp = viewport_arrays(reference_camera(), W, H)
    return np.asarray(render_band(
        ds, vp, band_h=band_h, width=W, y0=np.int32(y0),
        seed_y0=np.int32(y0), offset_x=np.int32(0), spp=np.int32(spp),
        number=np.uint32(number), accum_init=accum, max_depth=depth,
        backend=backend, pixels_per_lane=m))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_card_kernel_matches_bruteforce(gpu_device, mode):
    res = validation.backend_check("grid", "bruteforce", mode=mode)
    assert res["ok"], res


def test_card_kernel_matches_oracle_golden(gpu_device):
    res = validation.golden_check("grid", multi_tile=True)
    assert res["ok"], res


@pytest.mark.parametrize("m", [3, 16])
def test_card_m_invariance(gpu_device, book, m):
    assert np.array_equal(_render(book, "grid", m=1),
                          _render(book, "grid", m=m))


def test_card_band_invariance(gpu_device, book):
    whole = _render(book, "grid")
    band = _render(book, "grid", y0=24, band_h=24)
    assert np.array_equal(band, whole[24:48])


def test_card_progressive_accumulation(gpu_device, book):
    one = _render(book, "grid")
    two = _render(book, "grid", accum=one, number=1)
    assert np.array_equal(two, one + _render(book, "grid", number=1))


def test_card_dense_field_routes_to_grid(gpu_device):
    ds = prepare_scene(random_sphere_field(100_000, seed=1))
    assert resolve_backend("auto", ds) == "grid"
    img = _render(ds, "grid", spp=1)
    assert np.isfinite(img).all() and img.mean() > 0
