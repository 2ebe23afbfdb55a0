"""One wavefront iteration in row form — the step every backend shares.

Each lane owns M strided pixels and traces one ray segment per iteration
(module docstring of ops/trace.py).  The state is a tuple of 1-D per-lane
arrays (``Lanes``), so the same function runs on ``[n]`` arrays inside the
XLA ``while_loop`` of ops/trace.py and on ``[block]`` arrays inside the
Pallas-Triton kernel of ops/gridkernel.py.  Table reads are plain
``tab[row, idx]`` indexing, which is a gather on a ``jnp`` array and a
pointer gather on a Pallas ref; scalars are read the same way.

The op order follows the oracle (oracle/cpu_reference.py) and the GLSL it
mirrors: one shading implementation for every backend, so a backend's image
differs from ``bruteforce`` only through its closest-hit search.  The grid
march (``grid_hit``) uses bruteforce's quadratic term for term, which makes
the grid path bit-identical to it wherever the compiler contracts the same
multiply-adds (tests/test_grid.py).

Division goes through a ``div`` argument: plain ``/`` everywhere except the
compiled Triton kernel, which passes an IEEE round-to-nearest division
(Triton's own ``/`` on f32 is the approximate ``div.full.f32``).
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_RAY_COLLISION_DISTANCE, T_MIN
from . import materials
from .materials import dot3, normalize3
from . import rng as rngops
from .intersect import BIG

SKY = (np.float32(0.7), np.float32(0.8), np.float32(1.0))  # shader.rmiss:15
TMIN = np.float32(T_MIN)
TMAX = np.float32(MAX_RAY_COLLISION_DISTANCE)

# viewport vector slots (f32 [24], see viewport_vector)
V_H, V_V, V_UL, V_UP, V_RIGHT, V_FROM, V_AP, V_W, V_HGT = (
    0, 3, 6, 9, 12, 15, 18, 19, 20)
# per-call scalar slots (i32 [8], see call_scalars)
S_SPP, S_NUMBER, S_Y0, S_SEEDY0, S_OFFX = range(5)
# per-sphere attribute columns (f32 [S, A_COLS], see attr_table)
A_CEN, A_MAT, A_TEX, A_C0, A_C1, A_ATTR = 0, 3, 4, 5, 8, 11
A_COLS = 12


class Lanes(NamedTuple):
    """Per-lane wavefront state.  The last eight fields are the grid
    march's segment state; the brute-force backends carry them unchanged."""

    ox: jax.Array
    oy: jax.Array
    oz: jax.Array
    dx: jax.Array
    dy: jax.Array
    dz: jax.Array
    fx: jax.Array  # pixel x + offset (f32), shader.rgen:45
    fy: jax.Array
    tx: jax.Array  # path throughput
    ty: jax.Array
    tz: jax.Array
    cr: jax.Array  # running colour sum of the lane's current pixel
    cg: jax.Array
    cb: jax.Array
    tb: jax.Array  # grid: best hit t so far in this segment
    tend: jax.Array  # grid: ray's exit t from the grid box
    tnx: jax.Array  # grid: t of the next x / z cell crossing
    tnz: jax.Array
    seed: jax.Array  # u32 LCG state
    m: jax.Array  # i32 current pixel slot
    sidx: jax.Array  # i32 samples issued for the current pixel
    depth: jax.Array  # i32 bounce depth of the current path
    alive: jax.Array  # i32 0/1
    march: jax.Array  # i32 0/1: grid segment still marching
    win: jax.Array  # i32 grid: winning sphere id so far
    icx: jax.Array  # i32 grid: current cell, relative to the grid origin
    icz: jax.Array


def viewport_vector(vp) -> jax.Array:
    """Pack ViewportArrays (ops/trace.py) into the f32 [24] V_* layout."""
    return jnp.concatenate([
        jnp.asarray(vp.horizontal, jnp.float32),
        jnp.asarray(vp.vertical, jnp.float32),
        jnp.asarray(vp.upper_left, jnp.float32),
        jnp.asarray(vp.cam_up, jnp.float32),
        jnp.asarray(vp.cam_right, jnp.float32),
        jnp.asarray(vp.look_from, jnp.float32),
        jnp.reshape(jnp.asarray(vp.aperture, jnp.float32), (1,)),
        jnp.asarray(vp.size, jnp.float32),
        jnp.zeros((3,), jnp.float32),
    ])


def call_scalars(spp, number, y0, seed_y0, offset_x) -> jax.Array:
    """Pack a render call's dynamic scalars into the i32 [8] S_* layout."""
    num = jax.lax.bitcast_convert_type(jnp.asarray(number, jnp.uint32),
                                       jnp.int32)
    vals = [jnp.asarray(v, jnp.int32) for v in (spp, 0, y0, seed_y0, offset_x)]
    vals[S_NUMBER] = num
    return jnp.stack(vals + [jnp.int32(0)] * 3)


def attr_table(scene) -> np.ndarray:
    """f32 [S, A_COLS] per-sphere shading attributes (host numpy): centre,
    material, texture, colour0, colour1, fuzz / refraction index.  One row
    per sphere, so a winner's attributes are one contiguous fetch."""
    s = np.asarray(scene.centers).shape[0]
    out = np.zeros((s, A_COLS), np.float32)
    out[:, A_CEN:A_CEN + 3] = np.asarray(scene.centers, np.float32)
    out[:, A_MAT] = np.asarray(scene.material, np.float32)
    out[:, A_TEX] = np.asarray(scene.texture, np.float32)
    out[:, A_C0:A_C0 + 3] = np.asarray(scene.color0, np.float32)
    out[:, A_C1:A_C1 + 3] = np.asarray(scene.color1, np.float32)
    out[:, A_ATTR] = np.asarray(scene.attr, np.float32)
    return out


def _number(scal):
    return jax.lax.bitcast_convert_type(scal[S_NUMBER], jnp.uint32)


def pixel_coords(pix, scal, width):
    """uv pixel coords of band-local pixel ``pix`` (shader.rgen:45): the
    band's global row origin plus the local row."""
    fx = (scal[S_OFFX] + pix % width).astype(jnp.float32)
    fy = (scal[S_Y0] + pix // width).astype(jnp.float32)
    return fx, fy


def pixel_seed(pix, scal, width):
    """Fresh TEA seed of band-local pixel ``pix`` (shader.rgen:40), seeded
    from the ``seed_y0`` row origin."""
    px = (pix % width).astype(jnp.uint32)
    py_seed = (scal[S_SEEDY0] + pix // width).astype(jnp.uint32)
    return rngops.tea_hash(rngops.tea_hash(px, py_seed), _number(scal))


def camera_rays(seed, fx, fy, vpr, div):
    """getCameraRay + uv jitter (shader.rgen:57,107-115): four LCG draws."""
    seed, jx = rngops.random_float(seed)
    seed, jy = rngops.random_float(seed)
    u = div(fx + jx, vpr[V_W])
    v = div(fy + jy, vpr[V_HGT])
    seed, r1 = rngops.random_in_interval(seed, -1.0, 1.0)
    seed, r2 = rngops.random_in_interval(seed, -1.0, 1.0)
    # normalize(vec2(r1,r2)) * aperture/2 — aperture 0 in the reference (Q4)
    inv_l = div(jnp.float32(1.0), jnp.sqrt(r1 * r1 + r2 * r2))
    ap = vpr[V_AP] * jnp.float32(0.5)
    rx = ap * (r1 * inv_l)
    ry = ap * (r2 * inv_l)
    o = [vpr[V_FROM + c] + (vpr[V_RIGHT + c] * rx + vpr[V_UP + c] * ry)
         for c in range(3)]
    to = [vpr[V_UL + c] + vpr[V_H + c] * u - vpr[V_V + c] * v
          for c in range(3)]
    d = normalize3([to[c] - o[c] for c in range(3)], div)
    return seed, o, d


def init_lanes(lane, alive, scal, vpr, width, div=operator.truediv) -> Lanes:
    """Lane ``k`` starts on band pixel ``k`` (slot 0), first sample."""
    fx, fy = pixel_coords(lane, scal, width)
    seed, o, d = camera_rays(pixel_seed(lane, scal, width), fx, fy, vpr, div)
    z = jnp.zeros(lane.shape, jnp.float32)
    one = jnp.ones(lane.shape, jnp.float32)
    zi = jnp.zeros(lane.shape, jnp.int32)
    return Lanes(*o, *d, fx, fy, one, one, one, z, z, z, z, z, z, z,
                 seed, zi, zi + 1, zi, alive.astype(jnp.int32), zi, zi, zi, zi)


def quadratic(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, r, div):
    """Closest valid root of one sphere (shader.rint:32-60) in exactly the
    op order of intersect.intersect_bruteforce; BIG on a miss.  A NaN radius
    marks an empty table slot (disc is NaN, so ``ok`` is false)."""
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
    t1 = div(-b - sq, a)
    t2 = div(-b + sq, a)
    t1_ok = ok & (t1 >= TMIN) & (t1 <= TMAX)
    t2_ok = ok & (t2 >= TMIN) & (t2 <= TMAX)
    return jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, BIG))


def _slab(o_c, d_c, inv, lo, hi):
    """Ray vs axis slab [lo, hi] -> (t_enter, t_exit); a zero direction
    component gives the whole line inside or outside."""
    ta = (lo - o_c) * inv
    tb = (hi - o_c) * inv
    t0 = jnp.minimum(ta, tb)
    t1 = jnp.maximum(ta, tb)
    deg = d_c == 0.0
    inside = (o_c >= lo) & (o_c <= hi)
    t0 = jnp.where(deg, jnp.where(inside, -BIG, BIG), t0)
    t1 = jnp.where(deg, jnp.where(inside, BIG, -BIG), t1)
    return t0, t1


def grid_hit(st: Lanes, gtab, cellf, cellid, cellcnt, gscal, *, div):
    """Advance every lane's closest-hit search through the uniform grid
    (models/grid.py) by one segment start and a march over the (x, z)
    cells.

    A lane that needs a new segment tests the global spheres, clips its ray
    to the grid box and sets up an Amanatides-Woo march; each march step
    tests the cell's candidates and advances to the next cell until the
    next crossing lies beyond the best hit or the box; the march runs
    until no lane of the array is marching.  Returns (t, idx, hit, done,
    st): ``done`` marks lanes whose segment is resolved.
    """
    from ..models.grid import (G_NCX, G_NCZ, G_S, G_X0, G_XHI, G_XLO, G_YHI,
                               G_YLO, G_Z0, G_ZHI, G_ZLO)

    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    alive = st.alive != 0
    a = dx * dx + dy * dy + dz * dz

    need = alive & (st.march == 0)
    tb = jnp.where(need, BIG, st.tb)
    win = jnp.where(need, 0, st.win)
    for k in range(gtab.shape[0]):
        tc = quadratic(ox, oy, oz, dx, dy, dz, a, gtab[k, 0], gtab[k, 1],
                       gtab[k, 2], gtab[k, 3], div)
        upd = need & (tc < tb)
        tb = jnp.where(upd, tc, tb)
        win = jnp.where(upd, gtab[k, 4].astype(jnp.int32), win)

    one = jnp.float32(1.0)
    inv_x = div(one, dx)
    inv_y = div(one, dy)
    inv_z = div(one, dz)
    s_ = gscal[G_S]
    ncx = gscal[G_NCX]
    ncz = gscal[G_NCZ]
    t0x, t1x = _slab(ox, dx, inv_x, gscal[G_XLO], gscal[G_XHI])
    t0y, t1y = _slab(oy, dy, inv_y, gscal[G_YLO], gscal[G_YHI])
    t0z, t1z = _slab(oz, dz, inv_z, gscal[G_ZLO], gscal[G_ZHI])
    t_start = jnp.maximum(jnp.maximum(t0x, t0y), jnp.maximum(t0z, TMIN))
    t_end = jnp.minimum(jnp.minimum(t1x, t1y), t1z)
    start = need & (t_start <= t_end) & (t_start < tb)
    # entry cell on the half-integer lattice: cell c covers
    # [x0 + (c - 0.5) s, x0 + (c + 0.5) s); x0/z0 are cell 0's centre
    x0 = gscal[G_X0]
    z0 = gscal[G_Z0]
    icx_f = jnp.clip(jnp.floor(div(ox + t_start * dx - x0, s_) + 0.5),
                     0.0, ncx - 1.0)
    icz_f = jnp.clip(jnp.floor(div(oz + t_start * dz - z0, s_) + 0.5),
                     0.0, ncz - 1.0)
    bx = x0 + (icx_f + jnp.where(dx >= 0, 0.5, -0.5)) * s_
    bz = z0 + (icz_f + jnp.where(dz >= 0, 0.5, -0.5)) * s_
    tend = jnp.where(need, t_end, st.tend)
    tnx = jnp.where(start, jnp.where(dx == 0.0, BIG, (bx - ox) * inv_x),
                    st.tnx)
    tnz = jnp.where(start, jnp.where(dz == 0.0, BIG, (bz - oz) * inv_z),
                    st.tnz)
    icx = jnp.where(start, icx_f.astype(jnp.int32), st.icx)
    icz = jnp.where(start, icz_f.astype(jnp.int32), st.icz)
    marching = jnp.where(start, 1, st.march)

    step_x = jnp.where(dx >= 0, 1, -1)
    step_z = jnp.where(dz >= 0, 1, -1)
    dt_x = jnp.where(dx == 0.0, BIG, jnp.abs(inv_x) * s_)
    dt_z = jnp.where(dz == 0.0, BIG, jnp.abs(inv_z) * s_)
    cmax_x = ncx.astype(jnp.int32) - 1
    cmax_z = ncz.astype(jnp.int32) - 1
    nczi = ncz.astype(jnp.int32)

    def cell(carry):
        tb, win, tnx, tnz, icx, icz, marching = carry
        on = marching != 0
        cid = jnp.where(on, icx * nczi + icz, 0)
        cnt = jnp.where(on, cellcnt[cid], 0)

        def slot(s, c):
            tb, win = c
            tc = quadratic(ox, oy, oz, dx, dy, dz, a, cellf[cid, 4 * s],
                           cellf[cid, 4 * s + 1], cellf[cid, 4 * s + 2],
                           cellf[cid, 4 * s + 3], div)
            upd = (s < cnt) & (tc < tb)
            return (jnp.where(upd, tc, tb),
                    jnp.where(upd, cellid[cid, s], win))

        tb, win = jax.lax.fori_loop(0, jnp.max(cnt), slot, (tb, win))
        t_exit = jnp.minimum(tnx, tnz)
        cont = on & (t_exit < tb) & (t_exit < tend)
        cross_x = tnx <= tnz
        adv_x = cont & cross_x
        adv_z = cont & ~cross_x
        icx = jnp.where(adv_x, jnp.clip(icx + step_x, 0, cmax_x), icx)
        icz = jnp.where(adv_z, jnp.clip(icz + step_z, 0, cmax_z), icz)
        tnx = jnp.where(adv_x, tnx + dt_x, tnx)
        tnz = jnp.where(adv_z, tnz + dt_z, tnz)
        return tb, win, tnx, tnz, icx, icz, cont.astype(jnp.int32)

    tb, win, tnx, tnz, icx, icz, marching = jax.lax.while_loop(
        lambda c: jnp.max(c[-1]) > 0, cell,
        (tb, win, tnx, tnz, icx, icz, marching))

    done = alive & (marching == 0)
    st = st._replace(tb=tb, tend=tend, tnx=tnx, tnz=tnz, win=win, icx=icx,
                     icz=icz, march=marching)
    return tb, win, tb < BIG, done, st


def step(st: Lanes, lane, t, idx, hit, done, *, scal, vpr, atab, m_slots,
         n_lanes, p_total, width, max_depth, rr, div, gate_reseed=False):
    """Shade, terminate, accumulate and regenerate the lanes in ``done``
    (shader.rchit + shader.rgen:56-89); other lanes keep their state.

    ``t, idx, hit``: the segment's closest hit (sphere ``idx`` at ``t``).
    ``gate_reseed``: hash the next pixel's TEA seed only when some lane of
    the array advances to a new pixel (a branch on the whole array, worth
    it inside the kernel where an array is one block of lanes).  Returns
    (state, flush, pix, (r, g, b)): lanes in ``flush`` finished their pixel
    and add the colour sum to band pixel ``pix``.
    """
    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    d = [dx, dy, dz]
    seed = st.seed
    alive = st.alive != 0
    spp = scal[S_SPP]

    def attr(col):
        return atab[idx, col]

    # ---- shader.rchit: hit point, normal, texture, scatter -----------------
    p = [ox + t * dx, oy + t * dy, oz + t * dz]  # shader.rint:33
    out = normalize3([p[c] - attr(A_CEN + c) for c in range(3)], div)
    front = dot3(out, d) < 0.0
    n = [jnp.where(front, out[c], -out[c]) for c in range(3)]
    att = materials.texture_color(
        p, attr(A_TEX).astype(jnp.int32), [attr(A_C0 + c) for c in range(3)],
        [attr(A_C1 + c) for c in range(3)])
    seed_h, sd, does_scatter = materials.scatter(
        seed, d, n, front, attr(A_MAT).astype(jnp.int32), attr(A_ATTR), div)

    # ---- shader.rgen:70-89: termination, light, accumulation ---------------
    depth = st.depth
    cont = done & hit & does_scatter & ~((depth + 1) >= max_depth)
    thr = [st.tx, st.ty, st.tz]
    nthr = [thr[c] * att[c] for c in range(3)]
    seed_a = jnp.where(hit, seed_h, seed)
    if rr is not None:
        # Russian roulette (mode="fast"): past depth d0 a continuing path
        # survives with p = clamp(max throughput component, pmin, 1),
        # halved past d1, and its throughput is divided by p — unbiased
        d0, d1, pmin = rr
        dnext = depth + 1
        p_s = jnp.minimum(jnp.float32(1.0), jnp.maximum(
            jnp.float32(pmin),
            jnp.maximum(jnp.maximum(nthr[0], nthr[1]), nthr[2])))
        if d1:
            p_s = jnp.where(dnext >= d1, p_s * jnp.float32(0.5), p_s)
        considered = cont & (dnext >= d0)
        seed_rr, u_rr = rngops.random_float(seed_a)
        cont = cont & ~(considered & (u_rr >= p_s))
        nthr = [jnp.where(considered, div(nthr[c], p_s), nthr[c])
                for c in range(3)]
        seed_a = jnp.where(considered, seed_rr, seed_a)
    term = done & ~cont
    # lightSourceColor: sky on a miss, the albedo on an absorbed hit, 0 when
    # the depth cap kills a still-scattering path (rgen:74,82-89)
    cur = []
    for c, sky in enumerate(SKY):
        light = jnp.where(hit, jnp.where(does_scatter, 0.0, att[c]), sky)
        cur.append((st.cr, st.cg, st.cb)[c]
                   + jnp.where(term, thr[c] * light, 0.0))

    # ---- next sample, next pixel, or done ----------------------------------
    more = term & (st.sidx < spp)
    flush = term & ~more
    pix = st.m * n_lanes + lane
    m2 = st.m + flush.astype(jnp.int32)
    pix2 = m2 * n_lanes + lane
    adv = flush & (m2 < m_slots) & (pix2 < p_total)
    fx2, fy2 = pixel_coords(pix2, scal, width)
    if gate_reseed:
        fresh = jax.lax.cond(
            jnp.max(adv.astype(jnp.int32)) > 0,
            lambda: pixel_seed(pix2, scal, width),
            lambda: jnp.zeros(pix2.shape, jnp.uint32))
    else:
        fresh = pixel_seed(pix2, scal, width)
    regen = more | adv
    fxn = jnp.where(adv, fx2, st.fx)
    fyn = jnp.where(adv, fy2, st.fy)
    seed_r, o_r, d_r = camera_rays(jnp.where(adv, fresh, seed_a), fxn, fyn,
                                   vpr, div)
    bounce = normalize3(sd, div)  # shader.rgen:78

    o_new = [jnp.where(cont, p[c], jnp.where(regen, o_r[c], (ox, oy, oz)[c]))
             for c in range(3)]
    d_new = [jnp.where(cont, bounce[c], jnp.where(regen, d_r[c], d[c]))
             for c in range(3)]
    t_new = [jnp.where(cont, nthr[c], jnp.where(regen, 1.0, thr[c]))
             for c in range(3)]
    c_new = [jnp.where(flush, 0.0, cur[c]) for c in range(3)]
    st2 = st._replace(
        ox=o_new[0], oy=o_new[1], oz=o_new[2],
        dx=d_new[0], dy=d_new[1], dz=d_new[2],
        fx=fxn, fy=fyn, tx=t_new[0], ty=t_new[1], tz=t_new[2],
        cr=c_new[0], cg=c_new[1], cb=c_new[2],
        seed=jnp.where(done, jnp.where(regen, seed_r, seed_a), seed),
        m=m2,
        sidx=jnp.where(adv, 1, st.sidx + more.astype(jnp.int32)),
        depth=jnp.where(cont, depth + 1, jnp.where(regen, 0, depth)),
        alive=jnp.where(done, cont | regen, alive).astype(jnp.int32),
    )
    return st2, flush, pix, cur
