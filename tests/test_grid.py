"""Grid-DDA acceleration structure: builder + traversal parity on the book
scene.

The grid kernel (ops/gridkernel.py, Pallas interpret mode here) runs the
same wavefront step as ``bruteforce`` and differs only in the closest-hit
search; on the CPU both are the same jnp code, so the kernel must
reproduce ``bruteforce`` BIT FOR BIT.  The
compiled kernel's rounding on the card is checked by tests/test_gpu.py.
"""

import numpy as np
import pytest

from raytrace_tpu.models.grid import G_NCX, G_NCZ, G_S, build_grid
from raytrace_tpu.models.scene import (generate_random_scene,
                                       random_sphere_field,
                                       three_sphere_scene)
from raytrace_tpu.ops.trace import (prepare_scene, render_band,
                                    viewport_arrays)
from raytrace_tpu.runtime.renderer import reference_camera

W, H = 64, 36
RR = (1, 4, 0.05)  # tight fast-mode params so tiny renders exercise kills


@pytest.fixture(scope="module")
def book():
    return prepare_scene(generate_random_scene(0.0))


def _render(ds, backend, *, depth, spp, m=2, accum=None, number=0, rr=None,
            y0=0, band_h=H):
    vp = viewport_arrays(reference_camera(), W, H)
    return np.asarray(render_band(
        ds, vp, band_h=band_h, width=W, y0=np.int32(y0), seed_y0=np.int32(y0),
        offset_x=np.int32(0), spp=np.int32(spp), number=np.uint32(number),
        accum_init=accum, max_depth=depth, backend=backend,
        pixels_per_lane=m, rr=rr, interpret=backend == "grid"))


def test_builder_book_scene(book):
    g = book.grid
    assert g is not None
    # unit pitch, 23x23 half-integer lattice, <= 4 candidates per cell
    # (cx, cy, cz, r each), ground + 3 heroes global
    n_cells = int(g.gscal[G_NCX] * g.gscal[G_NCZ])
    assert g.cellf.shape == (n_cells, 16) and g.cellid.shape == (n_cells, 4)
    assert g.gscal[G_S] == 1.0
    assert list(g.gtab[:, 4]) == [0.0, 1.0, 2.0, 3.0]
    # every small sphere is registered in every cell its delta-enlarged
    # AABB overlaps: 1 cell when it fits inside one, up to 4 at a corner
    ids = np.concatenate([g.cellid[c, :g.cellcnt[c]] for c in range(n_cells)])
    counts = np.bincount(ids, minlength=488)
    assert counts[:4].sum() == 0
    assert ((counts[4:] >= 1) & (counts[4:] <= 4)).all()
    # candidates sorted by sphere id (brute force's lowest-index tie-break);
    # empty slots carry a NaN radius, which never hits
    for c in range(n_cells):
        k = g.cellcnt[c]
        assert (np.diff(g.cellid[c, :k]) > 0).all()
        assert np.isnan(g.cellf[c].reshape(-1, 4)[k:, 3]).all()


def test_builder_rejects_ungridable():
    assert prepare_scene(three_sphere_scene()).grid is None  # no small field
    # 70 small spheres stacked in one cell: past MAX_SLOTS candidates
    sc = random_sphere_field(70, seed=0, extent=4.0)
    sc.centers[4:74, 0] = 0.3
    sc.centers[4:74, 2] = 0.3
    sc.centers[4:74, 1] = 0.15 + 0.3 * np.arange(70, dtype=np.float32)
    sc.radii[4:74] = 0.1
    assert build_grid(sc) is None


def test_builder_dense_100k_field():
    """The 100k-sphere field (BASELINE config 5) builds a flat grid: the
    builder drops to pitch 0.5, where the worst cell holds a few dozen
    candidates, and the tables stay small enough for the GPU's L2."""
    g = build_grid(random_sphere_field(100_000, seed=1))
    assert g is not None
    assert g.gscal[G_S] == 0.5
    assert g.cellid.shape[1] <= 32
    nbytes = g.cellf.nbytes + g.cellid.nbytes + g.cellcnt.nbytes
    assert nbytes < 32 * 2**20, nbytes


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("m", [2, 5])  # M=5: a partial last block
def test_grid_bit_identical_to_bruteforce(book, m, mode):
    rr = RR if mode == "fast" else None
    a = _render(book, "bruteforce", depth=8, spp=2, m=m, rr=rr)
    b = _render(book, "grid", depth=8, spp=2, m=m, rr=rr)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_grid_full_depth_bit_identical(book, mode):
    rr = RR if mode == "fast" else None
    a = _render(book, "bruteforce", depth=50, spp=2, rr=rr)
    b = _render(book, "grid", depth=50, spp=2, rr=rr)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("m", [1, 5])
def test_grid_m_invariance(book, m):
    """pixels_per_lane never reorders a pixel's samples: bit-identical."""
    base = _render(book, "grid", depth=8, spp=2, m=2)
    assert np.array_equal(base, _render(book, "grid", depth=8, spp=2, m=m))


def test_grid_chunk_invariance(book):
    """A band rendered alone == those rows of the whole frame (global
    seeds), so internal chunking and device bands are invisible."""
    whole = _render(book, "grid", depth=8, spp=2)
    band = _render(book, "grid", depth=8, spp=2, y0=12, band_h=12)
    assert np.array_equal(band, whole[12:24])


def test_grid_progressive_accumulation(book):
    """Carried accumulators: call 2 adds its sums to call 1's, exactly as
    bruteforce does."""
    one = _render(book, "grid", depth=8, spp=2)
    two = _render(book, "grid", depth=8, spp=2, number=1, accum=one)
    bf1 = _render(book, "bruteforce", depth=8, spp=2)
    bf2 = _render(book, "bruteforce", depth=8, spp=2, number=1, accum=bf1)
    assert np.array_equal(one, bf1) and np.array_equal(two, bf2)
    assert (two >= one - 1e-6).all() and two.mean() > one.mean()
