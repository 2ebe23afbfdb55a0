"""The grid kernel's wrapper: block choice, lane padding, and lowering.

The kernel itself is checked bit for bit against ``bruteforce`` in interpret
mode by tests/test_grid*.py; these tests pin what surrounds it.
"""

import jax
import numpy as np
import pytest

from raytrace_tpu.models.scene import generate_random_scene
from raytrace_tpu.ops import gridkernel
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera


@pytest.mark.parametrize("n_lanes,expected", [
    (1, 32), (33, 64), (100, 128), (128, 128), (129, 128), (1 << 20, 128),
])
def test_block_choice(n_lanes, expected):
    """Blocks are powers of two, at least one warp, at most BLOCK."""
    assert gridkernel.block_lanes(n_lanes) == expected


@pytest.fixture(scope="module")
def book():
    return prepare_scene(generate_random_scene(0.0))


def _render(ds, backend, w, h, m):
    vp = viewport_arrays(reference_camera(), w, h)
    return np.asarray(render_band(
        ds, vp, band_h=h, width=w, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(1), number=np.uint32(0),
        max_depth=4, backend=backend, pixels_per_lane=m,
        interpret=backend == "grid"))


@pytest.mark.parametrize("w,h,m", [
    (16, 9, 2),   # 72 lanes in one 128-lane block: 56 padding lanes
    (16, 9, 3),   # 48 lanes: the block shrinks to 64
    (40, 9, 1),   # 360 lanes: 3 blocks, the last one partial
    (16, 8, 2),   # 64 lanes: one exact block
])
def test_lane_padding_bit_identical(book, w, h, m):
    """Padding lanes of the last block never touch live pixels."""
    assert np.array_equal(_render(book, "bruteforce", w, h, m),
                          _render(book, "grid", w, h, m))


def test_iteration_counts_per_block(book):
    """return_iters reports the longest block's loop count: at least one
    iteration per sample of a pixel, at most the depth cap per sample."""
    vp = viewport_arrays(reference_camera(), 40, 9)
    _, iters = render_band(
        book, vp, band_h=9, width=40, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(2), number=np.uint32(0),
        max_depth=4, backend="grid", pixels_per_lane=1, return_iters=True,
        interpret=True)
    assert 2 <= int(iters) <= 2 * 4 + 1


@pytest.mark.parametrize("rr", [None, (1, 16, 0.05)])
def test_kernel_lowers_to_triton(book, rr):
    """The compiled (non-interpret) kernel lowers to Triton IR for CUDA on
    any host — catches primitives Pallas-Triton cannot lower before the
    card sees them."""
    vp = viewport_arrays(reference_camera(), 64, 36)
    lowered = render_band.trace(
        book, vp, band_h=36, width=64, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(2), number=np.uint32(0),
        max_depth=50, backend="grid", pixels_per_lane=2, rr=rr,
    ).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()
