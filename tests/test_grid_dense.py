"""Dense sphere fields on the flat grid (the 100k-sphere field's regime,
BASELINE config 5, at a CPU-testable size).

2000 spheres over [-7, 7]^2 (~10 spheres per unit^2) crowd the unit
lattice, so the builder drops to pitch 0.5 with ~20 candidate slots per
cell; the grid kernel must still reproduce ``bruteforce`` bit for bit.
"""

import numpy as np
import pytest

from raytrace_tpu.models.grid import G_S
from raytrace_tpu.models.scene import CHECKERED, random_sphere_field
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera, resolve_backend

W, H = 48, 27
RR = (1, 4, 0.05)


@pytest.fixture(scope="module")
def dense():
    return prepare_scene(random_sphere_field(2000, seed=1, extent=7.0))


def _render(ds, backend, *, depth=6, spp=2, m=2, rr=None):
    vp = viewport_arrays(reference_camera(), W, H)
    return np.asarray(render_band(
        ds, vp, band_h=H, width=W, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(spp), number=np.uint32(0),
        max_depth=depth, backend=backend, pixels_per_lane=m, rr=rr,
        interpret=backend == "grid"))


def test_builder_dense(dense):
    g = dense.grid
    assert g is not None and g.gscal[G_S] == 0.5
    n_slots = g.cellid.shape[1]
    assert 8 < n_slots <= 32
    assert g.cellf.shape == (g.cellcnt.shape[0], 4 * n_slots)
    # every field sphere registered at least once, in id order per cell
    ids = np.concatenate([g.cellid[c, :k] for c, k in enumerate(g.cellcnt)])
    assert set(np.unique(ids)) == set(range(4, 2004))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("m", [2, 5])  # M=5: a partial last block
def test_dense_bit_identical(dense, m, mode):
    rr = RR if mode == "fast" else None
    a = _render(dense, "bruteforce", m=m, rr=rr)
    b = _render(dense, "grid", m=m, rr=rr)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("y_range", [None, (0.2, 2.0)])
def test_dense_textured_bit_identical(y_range):
    """Checkered field spheres in a dense field, at one height and at
    varying heights."""
    sc = random_sphere_field(2000, seed=1, extent=7.0, y_range=y_range)
    sc.texture[50:200] = CHECKERED
    sc.color1[50:200] = (0.9, 0.2, 0.1)
    ds = prepare_scene(sc)
    assert ds.grid is not None
    assert np.array_equal(_render(ds, "bruteforce", depth=5),
                          _render(ds, "grid", depth=5))


def test_dense_m_invariance(dense):
    assert np.array_equal(_render(dense, "grid", m=1),
                          _render(dense, "grid", m=3))


def test_auto_backend_picks_grid_for_dense(dense):
    assert resolve_backend("auto", dense, platform="gpu") == "grid"
    assert resolve_backend("auto", dense, platform="cpu") == "matmul"
