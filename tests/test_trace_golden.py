"""Golden tests: the jitted wavefront vs the straight-line CPU oracle.

This is the rebuild's replacement for the reference's missing test layer
(SURVEY.md §4): the oracle mirrors the GLSL control flow line-for-line with
the exact TEA+LCG stream, and the wavefront in ``bruteforce`` mode must match
it near-bitwise.  The ``matmul`` backend is validated statistically (its fp ordering differs,
which chaotically flips checker cells / grazing hits, but images must agree
in distribution); the grid kernel reproduces ``bruteforce`` bitwise
(tests/test_grid.py) and the oracle near-bitwise (below)."""

import numpy as np
import pytest

from raytrace_tpu.config import RenderCallInfo
from raytrace_tpu.models.scene import three_sphere_scene
from raytrace_tpu.oracle.cpu_reference import render_oracle
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera

W, H, SPP, DEPTH = 32, 18, 4, 8


@pytest.fixture(scope="module")
def scene():
    return three_sphere_scene()


@pytest.fixture(scope="module")
def oracle_img(scene):
    info = RenderCallInfo(samples_per_render_call=SPP, image_size=(W, H))
    return render_oracle(scene, info, max_depth=DEPTH)


def _render(scene, backend, spp=SPP, number=0, y0=0, band_h=H, seed_y0=None,
            accum=None, m=1):
    ds = prepare_scene(scene)
    vp = viewport_arrays(reference_camera(), W, H)
    out = render_band(
        ds, vp, band_h=band_h, width=W,
        y0=np.int32(y0), seed_y0=np.int32(y0 if seed_y0 is None else seed_y0),
        offset_x=np.int32(0), spp=np.int32(spp), number=np.uint32(number),
        accum_init=accum, max_depth=DEPTH, backend=backend, pixels_per_lane=m,
        interpret=backend == "grid")
    return np.asarray(out)


def test_bruteforce_matches_oracle_near_bitwise(scene, oracle_img):
    out = _render(scene, "bruteforce")
    diff = np.abs(out - oracle_img.astype(np.float32))
    assert diff.max() < 1e-4, f"max diff {diff.max()}"


def test_matmul_matches_statistically(scene, oracle_img):
    # vs oracle: mean agreement (different fp ordering => different MC noise)
    out16 = _render(scene, "matmul", spp=16) / 16
    ref = oracle_img / SPP
    assert abs(out16.mean() - ref.mean()) / ref.mean() < 0.05
    # vs bruteforce at the SAME spp: streams coincide except on fp-chaotic
    # pixels (checker seam / grazing hits), so most pixels match exactly
    bf = _render(scene, "bruteforce", spp=SPP) / SPP
    mm = _render(scene, "matmul", spp=SPP) / SPP
    close = np.abs(bf - mm).max(axis=2) < 0.05
    assert close.mean() > 0.85, f"only {close.mean():.2%} of pixels match"


def test_band_offset_consistency(scene):
    """Rendering rows [6,12) as a band with global seeds == those rows of the
    full render (internal chunking must be invisible)."""
    full = _render(scene, "bruteforce")
    band = _render(scene, "bruteforce", y0=6, band_h=6)
    assert np.array_equal(band, full[6:12])


def test_progressive_accumulation(scene):
    """Two chained calls carry the accumulator; with the same ``number`` the
    reference re-runs identical RNG streams (quirk Q3) so sum == 2x."""
    one = _render(scene, "bruteforce")
    two = _render(scene, "bruteforce", accum=one)
    assert np.allclose(two, 2 * one, rtol=1e-6)


def test_progressive_number_decorrelates(scene):
    """Distinct ``number`` reseeds (shader.rgen:40): call 1 != call 0, but
    statistics match."""
    a = _render(scene, "bruteforce", number=0)
    b = _render(scene, "bruteforce", number=1)
    assert not np.array_equal(a, b)
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05


def test_pixels_per_lane_invariant(scene):
    """Lane scheduling must not change per-pixel RNG streams: M=4 and M=7
    (non-divisor of the pixel count) are bit-identical to M=1."""
    base = _render(scene, "bruteforce", m=1)
    for m in (4, 7):
        out = _render(scene, "bruteforce", m=m)
        assert np.array_equal(out, base), f"pixels_per_lane={m} changed output"


@pytest.mark.parametrize("m", [1, 2])
def test_grid_backends_match_oracle_near_bitwise(m):
    """The grid kernel (interpret mode) against the oracle on the book
    scene — the scene the grid serves."""
    from raytrace_tpu.models.scene import generate_random_scene

    book = generate_random_scene(0.0)
    w, h = 16, 9
    info = RenderCallInfo(samples_per_render_call=1, image_size=(w, h))
    golden = render_oracle(book, info, max_depth=4)
    vp = viewport_arrays(reference_camera(), w, h)
    out = np.asarray(render_band(
        prepare_scene(book), vp, band_h=h, width=w, y0=np.int32(0),
        seed_y0=np.int32(0), offset_x=np.int32(0), spp=np.int32(1),
        number=np.uint32(0), max_depth=4, backend="grid",
        pixels_per_lane=m, interpret=True))
    assert np.abs(out - golden.astype(np.float32)).max() < 1e-4


def test_spp_zero_is_black(scene):
    out = _render(scene, "bruteforce", spp=0)
    assert np.all(out == 0)


def test_tonemap_roundtrip():
    from raytrace_tpu.ops.image import accum_to_u8

    accum = np.full((2, 2, 3), 4.0 * 0.25, np.float32)
    img = np.asarray(accum_to_u8(accum, 4))
    assert img.shape == (2, 2, 3)
    assert np.all(img == round(np.sqrt(0.25) * 255))


def test_large_sphere_table_renders():
    """Non-512 sphere tables (stretch scenes) go through every backend."""
    from raytrace_tpu.models.scene import random_sphere_field

    sc = random_sphere_field(300, seed=3, extent=12.0)
    bf = _render(sc, "bruteforce", spp=1)
    mm = _render(sc, "matmul", spp=1)
    gx = _render(sc, "grid", spp=1, m=2)
    assert mm.shape == gx.shape == (H, W, 3)
    assert np.array_equal(bf, gx)
    close = np.abs(mm - bf).max(axis=2) < 0.05
    assert close.mean() > 0.85


@pytest.mark.parametrize("m", [1, 3])
def test_matmul_progressive_accumulation(scene, m):
    """The carried accumulator through two chained calls on the matmul
    production path: call 2 adds exactly its own sums."""
    one = _render(scene, "matmul", m=m)
    two = _render(scene, "matmul", m=m, accum=one, number=1)
    fresh = _render(scene, "matmul", m=m, number=1)
    assert np.array_equal(two, one + fresh)
