"""Oracle path statistics: segments/sample and DDA cells/segment.

Produces the useful-work counts quoted in PERF.md: segments per sample
and unit-lattice grid cells marched per segment on the book scene (device
independent — these are counts of the algorithm's work, not times).

Runs the CPU oracle over randomly sampled pixels with the exact reference
RNG streams, hooking `_closest_hit` to count segments and replaying the
grid kernel's march-length rule per segment.

Usage: python scripts/path_stats.py [n_pixels] [spp]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from raytrace_tpu.models.grid import G_NCX, G_NCZ, G_X0, G_Z0, build_grid
from raytrace_tpu.models.scene import generate_random_scene
from raytrace_tpu.ops import rng as rngops
from raytrace_tpu.ops.trace import viewport_arrays
from raytrace_tpu.oracle import cpu_reference as orc
from raytrace_tpu.runtime.renderer import reference_camera

W, H = 1920, 1080
BIG = 3e30


def main() -> int:
    n_px = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    sc = generate_random_scene(0.0)
    g = build_grid(sc, pitch=1.0)  # unit lattice: cell index == world x/z
    gs = np.asarray(g.gscal)
    xlo, xhi, ylo, yhi, zlo, zhi = gs[0], gs[1], gs[2], gs[3], gs[4], gs[5]
    cminx, cminz = gs[G_X0], gs[G_Z0]
    cmaxx, cmaxz = cminx + gs[G_NCX] - 1, cminz + gs[G_NCZ] - 1

    glob = [i for i in range(int(sc.n_spheres)) if sc.radii[i] > 0.49]
    stats = {"segments": 0, "cells": 0, "samples": 0}

    def slab(oc, dc, lo, hi):
        if dc == 0.0:
            return (-BIG, BIG) if lo <= oc <= hi else (BIG, -BIG)
        ta, tb = (lo - oc) / dc, (hi - oc) / dc
        return min(ta, tb), max(ta, tb)

    def cells_for(o, d, t_glob):
        """March length by the kernel's rule (upper bound: ignores grid-hit
        pruning, which only shortens it)."""
        t0x, t1x = slab(o[0], d[0], xlo, xhi)
        t0y, t1y = slab(o[1], d[1], ylo, yhi)
        t0z, t1z = slab(o[2], d[2], zlo, zhi)
        ts = max(t0x, t0y, t0z, 1e-3)
        te = min(t1x, t1y, t1z)
        if ts > te or ts >= t_glob:
            return 0
        px, pz = o[0] + ts * d[0], o[2] + ts * d[2]
        icx = np.clip(np.floor(px + 0.5), cminx, cmaxx)
        icz = np.clip(np.floor(pz + 0.5), cminz, cmaxz)
        bx = icx + (0.5 if d[0] >= 0 else -0.5)
        bz = icz + (0.5 if d[2] >= 0 else -0.5)
        tnx = BIG if d[0] == 0 else (bx - o[0]) / d[0]
        tnz = BIG if d[2] == 0 else (bz - o[2]) / d[2]
        dtx = BIG if d[0] == 0 else abs(1.0 / d[0])
        dtz = BIG if d[2] == 0 else abs(1.0 / d[2])
        n = 1
        while True:
            t_exit = min(tnx, tnz)
            if t_exit >= t_glob or t_exit >= te or n > 60:
                return n
            if tnx <= tnz:
                icx += np.sign(d[0])
                tnx += dtx
            else:
                icz += np.sign(d[2])
                tnz += dtz
            n += 1

    orig = orc._closest_hit

    def hooked(scene, o, d, tmin, tmax):
        stats["segments"] += 1
        tg = BIG  # globals-only nearest t: the march's pruning bound
        for i in glob:
            oc = np.asarray(o, np.float64) - scene.centers[i]
            dd = np.asarray(d, np.float64)
            a = float(dd @ dd)
            b = float(oc @ dd)
            c = float(oc @ oc) - float(scene.radii[i]) ** 2
            disc = b * b - a * c
            if disc >= 0:
                for t in ((-b - np.sqrt(disc)) / a, (-b + np.sqrt(disc)) / a):
                    if 1e-3 <= t < tg:
                        tg = t
                        break
        stats["cells"] += cells_for(
            np.asarray(o, np.float64), np.asarray(d, np.float64), tg)
        return orig(scene, o, d, tmin, tmax)

    orc._closest_hit = hooked
    try:
        vp = viewport_arrays(reference_camera(), W, H)
        up = np.asarray(vp.upper_left)
        hor = np.asarray(vp.horizontal)
        ver = np.asarray(vp.vertical)
        frm = np.asarray(vp.look_from)
        rng = np.random.default_rng(0)
        for _ in range(n_px):
            px = int(rng.integers(0, W))
            py = int(rng.integers(0, H))
            seed = rngops.tea_hash(
                rngops.tea_hash(np.uint32(px), np.uint32(py)), np.uint32(0))
            for _s in range(spp):
                seed, r1 = rngops.random_float(seed)
                seed, r2 = rngops.random_float(seed)
                u = (px + r1) / W
                v = (py + r2) / H
                # NOTE: vertical is SUBTRACTED (shader.rgen:58 / trace.py
                # _camera_rays).  The r2 version added it — sampling a
                # vertically mirrored, sky-heavy image — which underestimated
                # the useful floor ~2.6x (1.92 segments/sample, 0.39
                # cells/segment); the corrected numbers are ~4-5
                # iterations/sample with ~2.4 cells/segment
                # (scripts/straggler_stats.py).
                d = up + u * hor - v * ver - frm
                seed, _ = rngops.random_float(seed)  # aperture draws (Q4: no-op)
                seed, _ = rngops.random_float(seed)
                seed, _c = orc._ray_color(
                    sc, frm.astype(np.float32), d.astype(np.float32), seed, 50)
                stats["samples"] += 1
    finally:
        orc._closest_hit = orig

    print(stats)
    print("segments/sample: %.2f   cells/segment: %.2f" % (
        stats["segments"] / stats["samples"],
        stats["cells"] / max(stats["segments"], 1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
