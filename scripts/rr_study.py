"""Russian-roulette prize study (round-4 fast mode, VERDICT r3 item 1).

Replays the kernel's iterations-per-segment rule (straggler_stats.py
methodology: exact RNG streams, oracle scatter math, iteration count =
max(1, cells marched) per segment) for several RR policies and reports the
useful-iteration savings — the upper bound of the fast-mode win from path
termination alone.

RR policy (the standard unbiased estimator): after a scatter at depth >=
d0, survive with p = min(1, max component of throughput) (optionally
p *= 0.5 past depth d1 to bound glass paths whose throughput stays ~1);
on survival divide throughput by p.  Expectation is unchanged; variance
rises only on the killed paths' pixels.

Usage: python scripts/rr_study.py [n_pixels] [spp]
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
    n_px = int(sys.argv[1]) if len(sys.argv) > 1 else 1200
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 4
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
        """Kernel iterations for one segment: max(1, ceil(cells/2)) at j=2."""
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

    def ray_color_rr(o, d, seed, max_depth, d0, d1):
        """orc._ray_color with RR + per-segment kernel-iteration counting.
        Returns (seed, rgb, iters)."""
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
                p = min(1.0, float(reflected.max()))
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

    policies = [("baseline", None, None), ("rr d0=2", 2, None),
                ("rr d0=3", 3, None), ("rr d0=4", 4, None),
                ("rr d0=2 d1=16", 2, 16), ("rr d0=3 d1=24", 3, 24)]
    cost = {name: np.zeros(n_px) for name, _, _ in policies}
    mean_col = {name: np.zeros(3) for name, _, _ in policies}
    for j, p in enumerate(pix):
        px, py = int(p % W), int(p // W)
        for name, d0, d1 in policies:
            seed = rngops.tea_hash(
                rngops.tea_hash(np.uint32(px), np.uint32(py)), np.uint32(0))
            tot_it = 0
            for _s in range(spp):
                seed, r1 = rngops.random_float(seed)
                seed, r2 = rngops.random_float(seed)
                u = (px + r1) / W
                v = (py + r2) / H
                d = up + u * hor - v * ver - frm
                seed, _ = rngops.random_float(seed)
                seed, _ = rngops.random_float(seed)
                seed, col, it = ray_color_rr(
                    frm.astype(np.float32), d.astype(np.float32), seed, 50,
                    d0, d1)
                tot_it += it
                mean_col[name] += col / (n_px * spp)
            cost[name][j] = tot_it / spp
        if (j + 1) % 200 == 0:
            print(f"{j+1}/{n_px} pixels...", flush=True)

    base = cost["baseline"].mean()
    for name, _, _ in policies:
        c = cost[name]
        q = np.percentile(c, [50, 90, 99])
        print(f"{name:<16} mean {c.mean():.3f} ({c.mean()/base:.3f}x)  "
              f"p50 {q[0]:.1f} p90 {q[1]:.1f} p99 {q[2]:.1f} max {c.max():.1f}"
              f"  mean-color {mean_col[name].round(4)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
