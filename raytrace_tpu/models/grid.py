"""Uniform-grid acceleration structure for the grid backends.

Replaces the reference's hardware BVH (src/vulkan.h:395-554
BLAS/TLAS + :994 traceRaysKHR): rays march an Amanatides-Woo DDA over a
uniform (x, z) cell lattice (ops/wavefront.py ``grid_hit``), testing each
cell's candidate spheres.  The book scene lays its 484 field spheres on a
22x22 unit lattice (scene.h:118-125), so a uniform grid is the ideal
structure for it.  Cells are y-columns clipped by the field's y slab, so
fields at varying heights cost extra candidate tests, not a 3-D march.
Large spheres (ground, heroes) would crowd every cell; they go to a small
"global" table that every segment tests.

Exactness contract (the grid backends must reproduce brute force):
 - every sphere is registered in every cell its DELTA-enlarged AABB
   touches, so DDA rounding (~1e-4 world units) cannot skip a hit;
 - candidates carry the scene's own (cx, cy, cz, r) values and the march
   runs brute force's quadratic term for term (wavefront.quadratic);
 - candidates within a cell are sorted by sphere id and compared with
   strict ``<``, and cells are visited in ray order, reproducing brute
   force's lowest-index tie-break (up to exact ties across cells, which
   have no probability mass).

Layout (flat, indexed by cell id ``ix * ncz + iz``): one row per cell, so a
cell's candidates are contiguous in memory — one or two cache lines per
cell fetch on the GPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

DELTA = 1e-2  # conservative AABB enlargement (>> DDA rounding)
MAX_GLOBALS = 16  # large spheres tested by every segment; more -> no grid
MAX_SLOTS = 64  # candidates per cell; a scene crowding past this is better
#                 served by brute force than by a grid of padded cells
MAX_CELLS = 1 << 22  # table size guard (64 MB of cell rows at 4 slots)
PITCHES = (1.0, 0.5)  # candidate cell sizes, coarsest first
SLOT_TARGET = 8  # the first pitch whose worst cell fits this many wins


class GridTables(NamedTuple):
    """Device tables of the grid backends (a pure array pytree: the slot
    and global counts are static under jit through the array shapes)."""

    gtab: np.ndarray  # f32 [G, 5] global spheres: cx, cy, cz, r, id
    #                   (G >= 1; padding rows have r = NaN and never hit)
    cellf: np.ndarray  # f32 [n_cells, 4 * n_slots]: per slot (cx, cy, cz, r)
    #                    sorted by sphere id; empty slots have r = NaN
    cellid: np.ndarray  # i32 [n_cells, n_slots] sphere id per slot
    cellcnt: np.ndarray  # i32 [n_cells] occupied slots per cell
    gscal: np.ndarray  # f32 [G_ROWS] lattice scalars (G_* slots)


# gscal slots: the grid box, the world position of cell (0, 0)'s centre,
# the cell counts and the pitch
G_XLO, G_XHI, G_YLO, G_YHI, G_ZLO, G_ZHI = range(6)
G_X0, G_Z0, G_NCX, G_NCZ, G_S = range(6, 11)
G_ROWS = 16


def build_grid(scene, pitch: Optional[float] = None,
               max_slots: int = MAX_SLOTS) -> Optional[GridTables]:
    """Grid tables for a SceneArrays, or None when the scene does not fit
    the structure (no small spheres, more than MAX_GLOBALS large ones, a
    cell crowded past ``max_slots``); such scenes render by brute force.

    ``pitch``: cell size in world units.  None tries PITCHES coarsest
    first and keeps the first whose worst cell holds <= SLOT_TARGET
    candidates, else the one with the fewest slots.  The image is
    pitch-independent: the enlarged registration absorbs DDA rounding at
    any pitch (tests/test_grid_pitch.py).
    """
    if pitch is not None:
        return _build(scene, float(pitch), max_slots)
    best = None
    for p in PITCHES:
        g = _build(scene, p, max_slots)
        if g is None:
            continue
        if g.cellid.shape[1] <= SLOT_TARGET:
            return g
        if best is None or g.cellid.shape[1] < best.cellid.shape[1]:
            best = g
    return best


def _build(scene, pitch: float, max_slots: int) -> Optional[GridTables]:
    centers = np.asarray(scene.centers, np.float32)
    radii = np.asarray(scene.radii, np.float32)
    n = int(scene.n_spheres)
    if n == 0:
        return None
    s_pitch = np.float32(pitch)

    # a sphere is grid-eligible when its enlarged AABB spans <= 2 cells per
    # axis (2 (r + DELTA) <= pitch); the absolute 0.5 cap keeps genuinely
    # large spheres (heroes, ground) global at coarse pitches too
    ids = np.arange(n)
    small = radii[:n] <= min(pitch, 1.0) / 2 - DELTA
    g_idx = ids[~small]
    s_idx = ids[small]
    if len(g_idx) > MAX_GLOBALS or len(s_idx) == 0:
        return None

    cx, cy, cz = centers[s_idx, 0], centers[s_idx, 1], centers[s_idx, 2]
    r = radii[s_idx]
    # half-integer lattice: cell c covers [(c - 0.5) s, (c + 0.5) s)
    rr = r + np.float32(DELTA)
    ix0 = np.floor((cx - rr) / s_pitch + 0.5).astype(np.int64)
    ix1 = np.floor((cx + rr) / s_pitch + 0.5).astype(np.int64)
    iz0 = np.floor((cz - rr) / s_pitch + 0.5).astype(np.int64)
    iz1 = np.floor((cz + rr) / s_pitch + 0.5).astype(np.int64)
    cmin_x, cmax_x = int(ix0.min()), int(ix1.max())
    cmin_z, cmax_z = int(iz0.min()), int(iz1.max())
    ncx = cmax_x - cmin_x + 1
    ncz = cmax_z - cmin_z + 1
    n_cells = ncx * ncz
    if n_cells > MAX_CELLS:
        return None

    # (cell, sphere) registrations: every cell the enlarged AABB overlaps
    cells, members = [], []
    for ox in range(int((ix1 - ix0).max()) + 1):
        for oz in range(int((iz1 - iz0).max()) + 1):
            m = (ix0 + ox <= ix1) & (iz0 + oz <= iz1)
            cells.append((ix0[m] + ox - cmin_x) * ncz + (iz0[m] + oz - cmin_z))
            members.append(np.nonzero(m)[0])
    cells = np.concatenate(cells)
    members = np.concatenate(members)
    order = np.lexsort((s_idx[members], cells))  # by cell, then sphere id
    cells, members = cells[order], members[order]
    count = np.bincount(cells, minlength=n_cells)
    n_slots = int(count.max())
    if n_slots > max_slots:
        return None
    first = np.cumsum(count) - count
    slot = np.arange(len(cells)) - first[cells]

    cellf = np.zeros((n_cells, n_slots, 4), np.float32)
    cellf[..., 3] = np.nan
    cellf[cells, slot] = np.stack(
        [cx[members], cy[members], cz[members], r[members]], axis=1)
    cellid = np.zeros((n_cells, n_slots), np.int32)
    cellid[cells, slot] = s_idx[members]

    gtab = np.zeros((max(1, len(g_idx)), 5), np.float32)
    gtab[:, 3] = np.nan
    gtab[:len(g_idx), 0:3] = centers[g_idx]
    gtab[:len(g_idx), 3] = radii[g_idx]
    gtab[:len(g_idx), 4] = g_idx

    gscal = np.zeros((G_ROWS,), np.float32)
    gscal[G_XLO] = (np.float32(cmin_x) - 0.5) * s_pitch
    gscal[G_XHI] = (np.float32(cmax_x) + 0.5) * s_pitch
    gscal[G_YLO] = (cy - r).min() - np.float32(DELTA)
    gscal[G_YHI] = (cy + r).max() + np.float32(DELTA)
    gscal[G_ZLO] = (np.float32(cmin_z) - 0.5) * s_pitch
    gscal[G_ZHI] = (np.float32(cmax_z) + 0.5) * s_pitch
    gscal[G_X0] = np.float32(cmin_x) * s_pitch
    gscal[G_Z0] = np.float32(cmin_z) * s_pitch
    gscal[G_NCX] = ncx
    gscal[G_NCZ] = ncz
    gscal[G_S] = s_pitch
    return GridTables(gtab=gtab, cellf=cellf.reshape(n_cells, 4 * n_slots),
                      cellid=cellid, cellcnt=count.astype(np.int32),
                      gscal=gscal)
