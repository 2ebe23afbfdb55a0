"""Grid cell-pitch generality: output is invariant to the lattice pitch.

Coarser cells (models/grid.py build_grid(pitch=...)) trade march steps for
candidate quadratics; the delta-enlarged registration makes the winner set
— and the image BITS — pitch-independent.
"""

import numpy as np
import pytest

from raytrace_tpu.models.grid import G_S, build_grid
from raytrace_tpu.models.scene import generate_random_scene, random_sphere_field
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera

W, H = 64, 36


@pytest.fixture(scope="module")
def book_scene():
    return generate_random_scene(0.0)


def _render(ds, *, depth=8, spp=2, m=2, backend="grid"):
    vp = viewport_arrays(reference_camera(), W, H)
    return np.asarray(render_band(
        ds, vp, band_h=H, width=W, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(spp), number=np.uint32(0),
        max_depth=depth, backend=backend, pixels_per_lane=m,
        interpret=backend == "grid"))


@pytest.mark.parametrize("pitch", [0.5, 2.0])
def test_pitch_invariance_bitwise(book_scene, pitch):
    ds = prepare_scene(book_scene)
    base = _render(ds)
    g = build_grid(book_scene, pitch=pitch)
    assert g is not None and g.gscal[G_S] == pitch
    assert np.array_equal(base, _render(ds._replace(grid=g)))


def test_auto_pitch_mode(book_scene):
    """pitch=None: the coarsest pitch whose worst cell holds <= 8
    candidates (the book's unit lattice), else the fewest slots (dense
    fields drop to 0.5)."""
    assert prepare_scene(book_scene).grid.gscal[G_S] == 1.0
    dense = prepare_scene(random_sphere_field(2000, seed=1, extent=7.0))
    assert dense.grid.gscal[G_S] == 0.5
    assert dense.grid.cellid.shape[1] > 8


def test_pitch2_builder_shapes(book_scene):
    """Pitch 2 on the book scene: 8 candidates per cell on a 13x13
    lattice; the heroes and the ground stay global (the 0.5 cap)."""
    g = build_grid(book_scene, pitch=2.0)
    assert g.cellid.shape == (169, 8) and g.cellf.shape == (169, 32)
    assert list(g.gtab[:, 4]) == [0.0, 1.0, 2.0, 3.0]
