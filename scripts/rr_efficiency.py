"""RR policy efficiency study (round 4): is the fast default optimal?

Russian roulette trades work for variance; the honest scalar is the
inverse efficiency E[cost] * Var[estimator] (lower = better) — a policy
only deserves to replace the default if it wins on THIS product, not just
on raw time (any policy can buy time with variance at fixed spp).

Replays the oracle (exact GLSL semantics + TEA/LCG streams, as
scripts/rr_study.py) per policy and reports, over a random pixel set:
  cost     mean kernel iterations per sample (j=2 rule)
  var      per-pixel sample variance, RGB-averaged, pixel-averaged
  cost*var inverse efficiency, normalized to the no-RR baseline

Policies: the exact baseline, the shipped fast default (d0=1 d1=16
pmin=.05, p = max throughput component), the conservative d0=2 point,
a luminance-weighted p, and p-scaled (more aggressive) variants.

Usage: python scripts/rr_efficiency.py [n_pixels] [spp]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from raytrace_tpu.config import MAX_RAY_COLLISION_DISTANCE, T_MIN
from raytrace_tpu.models.grid import G_NCX, G_NCZ, G_X0, G_Z0, build_grid
from raytrace_tpu.models.scene import generate_random_scene
from raytrace_tpu.ops import rng as rngops
from raytrace_tpu.ops.trace import viewport_arrays
from raytrace_tpu.oracle import cpu_reference as orc
from raytrace_tpu.runtime.renderer import reference_camera

W, H = 1920, 1080
BIG = 3e30
F = np.float32


def main() -> int:
    n_px = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    sc = generate_random_scene(0.0)
    g = build_grid(sc, pitch=1.0)  # unit lattice: cell index == world x/z
    gs = np.asarray(g.gscal)
    xlo, xhi, ylo, yhi, zlo, zhi = gs[0], gs[1], gs[2], gs[3], gs[4], gs[5]
    cminx, cminz = gs[G_X0], gs[G_Z0]
    cmaxx, cmaxz = cminx + gs[G_NCX] - 1, cminz + gs[G_NCZ] - 1
    glob = [i for i in range(int(sc.n_spheres)) if sc.radii[i] > 0.49]

    def slab(oc, dc, lo, hi):
        if dc == 0.0:
            return (-BIG, BIG) if lo <= oc <= hi else (BIG, -BIG)
        ta, tb = (lo - oc) / dc, (hi - oc) / dc
        return min(ta, tb), max(ta, tb)

    def iters_for(o, d, t_glob):
        t0x, t1x = slab(o[0], d[0], xlo, xhi)
        t0y, t1y = slab(o[1], d[1], ylo, yhi)
        t0z, t1z = slab(o[2], d[2], zlo, zhi)
        ts = max(t0x, t0y, t0z, 1e-3)
        te = min(t1x, t1y, t1z)
        if ts > te or ts >= t_glob:
            return 1
        px, pz = o[0] + ts * d[0], o[2] + ts * d[2]
        icx = np.clip(np.floor(px + 0.5), cminx, cmaxx)
        icz = np.clip(np.floor(pz + 0.5), cminz, cmaxz)
        bx = icx + (0.5 if d[0] >= 0 else -0.5)
        bz = icz + (0.5 if d[2] >= 0 else -0.5)
        tnx = BIG if d[0] == 0 else (bx - o[0]) / d[0]
        tnz = BIG if d[2] == 0 else (bz - o[2]) / d[2]
        dtx = BIG if d[0] == 0 else abs(1.0 / d[0])
        dtz = BIG if d[2] == 0 else abs(1.0 / d[2])
        cells = 1
        while True:
            t_exit = min(tnx, tnz)
            if t_exit >= t_glob or t_exit >= te or cells > 60:
                break
            if tnx <= tnz:
                icx += np.sign(d[0])
                tnx += dtx
            else:
                icz += np.sign(d[2])
                tnz += dtz
            cells += 1
        return max(1, -(-cells // 2))  # cost model: two cells per iteration

    def closest_with_glob(o, d):
        tg = BIG
        for i in glob:
            oc = np.asarray(o, np.float64) - sc.centers[i]
            dd = np.asarray(d, np.float64)
            a = float(dd @ dd)
            b = float(oc @ dd)
            c = float(oc @ oc) - float(sc.radii[i]) ** 2
            disc = b * b - a * c
            if disc >= 0:
                for t in ((-b - np.sqrt(disc)) / a, (-b + np.sqrt(disc)) / a):
                    if 1e-3 <= t < tg:
                        tg = t
                        break
        return tg

    def p_max(refl):
        return float(refl.max())

    def p_lum(refl):
        return float(0.2126 * refl[0] + 0.7152 * refl[1] + 0.0722 * refl[2])

    def ray_color_rr(o, d, seed, max_depth, d0, d1, pmin, prule, pscale):
        reflected = np.ones(3, np.float32)
        light = np.zeros(3, np.float32)
        iters = 0
        for depth in range(max_depth):
            tg = closest_with_glob(o, d)
            iters += iters_for(np.asarray(o, np.float64),
                               np.asarray(d, np.float64), tg)
            i, t = orc._closest_hit(sc, o, d, F(T_MIN),
                                    F(MAX_RAY_COLLISION_DISTANCE))
            if i < 0:
                light = orc.SKY_COLOR
                break
            point = o + t * d
            outward = orc._normalize(point - sc.centers[i])
            front_face = np.dot(d, outward) < 0
            normal = outward if front_face else -outward
            attenuation = orc._texture_color(sc, i, point)
            seed, sd = orc._scatter(sc, i, d, normal, front_face, seed)
            if sd is None:
                light = attenuation
                break
            reflected = reflected * attenuation
            o = point
            d = orc._normalize(sd).astype(np.float32)
            if d0 is not None and depth + 1 >= d0:
                p = min(1.0, max(pmin, pscale * prule(reflected)))
                if d1 is not None and depth + 1 >= d1:
                    p *= 0.5
                seed, u = rngops.random_float(seed)
                if u >= p:
                    break  # killed: contributes reflected * 0
                reflected = reflected / F(p)
        return seed, reflected * light, iters

    vp = viewport_arrays(reference_camera(), W, H)
    up = np.asarray(vp.upper_left)
    hor = np.asarray(vp.horizontal)
    ver = np.asarray(vp.vertical)
    frm = np.asarray(vp.look_from)
    rng = np.random.default_rng(0)
    pix = rng.choice(W * H, size=n_px, replace=False)

    # (name, d0, d1, pmin, prule, pscale)
    policies = [
        ("exact", None, None, 0.0, p_max, 1.0),
        ("rr(2,16) max", 2, 16, 0.05, p_max, 1.0),
        ("rr(1,16) max*", 1, 16, 0.05, p_max, 1.0),  # shipped default
        ("rr(1,16) lum", 1, 16, 0.05, p_lum, 1.0),
        ("rr(1,16) 0.8p", 1, 16, 0.05, p_max, 0.8),
        ("rr(1,16) 0.6p", 1, 16, 0.05, p_max, 0.6),
    ]
    cost = {n: np.zeros(n_px) for n, *_ in policies}
    var = {n: np.zeros(n_px) for n, *_ in policies}
    mean_col = {n: np.zeros(3) for n, *_ in policies}
    for j, p in enumerate(pix):
        px, py = int(p % W), int(p // W)
        for name, d0, d1, pmin, prule, pscale in policies:
            seed = rngops.tea_hash(
                rngops.tea_hash(np.uint32(px), np.uint32(py)), np.uint32(0))
            tot_it = 0
            cols = np.zeros((spp, 3))
            for s in range(spp):
                seed, r1 = rngops.random_float(seed)
                seed, r2 = rngops.random_float(seed)
                u = (px + r1) / W
                v = (py + r2) / H
                d = up + u * hor - v * ver - frm
                seed, _ = rngops.random_float(seed)
                seed, _ = rngops.random_float(seed)
                seed, col, it = ray_color_rr(
                    frm.astype(np.float32), d.astype(np.float32), seed, 50,
                    d0, d1, pmin, prule, pscale)
                tot_it += it
                cols[s] = col
            cost[name][j] = tot_it / spp
            var[name][j] = cols.var(axis=0, ddof=1).mean()
            mean_col[name] += cols.mean(axis=0) / n_px
        if (j + 1) % 100 == 0:
            print(f"{j+1}/{n_px} pixels...", flush=True)

    base_c = cost["exact"].mean()
    base_e = base_c * var["exact"].mean()
    print(f"\n{'policy':<16} {'cost':>6} {'rel':>6} {'var':>9} {'rel':>6} "
          f"{'cost*var':>8}  mean-color")
    for name, *_ in policies:
        c, v = cost[name].mean(), var[name].mean()
        print(f"{name:<16} {c:6.3f} {c/base_c:6.3f} {v:9.5f} "
              f"{v/var['exact'].mean():6.3f} {c*v/base_e:8.3f}  "
              f"{mean_col[name].round(4)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
