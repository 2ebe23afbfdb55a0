"""Vectorized ray-sphere intersection (the hot op).

Replaces the reference's hardware acceleration-structure traversal +
intersection shader (/root/reference/shaders/shader.rint:22-60 and the
BLAS/TLAS machinery of the reference's src/vulkan.h:395-554) for scenes
without a grid (models/grid.py): a dense ray-vs-all-spheres test with a
min-reduction.

Math matches calculateIntersections (shader.rint:44-60): half-b quadratic,
report t1 if in [tMin, tMax] else t2 (shader.rint:32-39); the hardware's
closest-hit selection becomes an argmin over the sphere axis.

Two algebraic forms are provided:

- ``intersect_bruteforce``: direct ``oc = o - c`` form, bit-matching the
  oracle/GLSL order of operations.  Materializes [N, S, 3]; used for tests
  and small N.
- ``intersect_matmul``: expanded form where the two ray-sphere contractions
  ``c . d`` and ``c . o`` are [N,3] @ [3,S] matrix products, and the
  per-sphere constant ``|c|^2 - r^2`` is precomputed in f64 on the host (more
  accurate than the reference's f32 ``dot(oc,oc) - r*r``).  This is the
  brute-force production path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3.0e38)  # sentinel "no hit" t (finite to keep argmin sane)


def sphere_constants(centers, radii):
    """Precompute |c|^2 - r^2 per sphere (host or device, f32 result).

    Done in float64 then cast: for the ground sphere |c|^2 and r^2 are ~1e6
    and their difference is 1.0 — f64 precompute removes the cancellation the
    reference pays in f32 (SURVEY.md "hard parts" (d))."""
    c64 = np.asarray(centers, np.float64)
    r64 = np.asarray(radii, np.float64)
    return (np.sum(c64 * c64, axis=1) - r64 * r64).astype(np.float32)


def intersect_bruteforce(o, d, centers, radii, valid, tmin, tmax):
    """Direct GLSL-order form. o,d: [N,3]; centers: [S,3]; radii,valid: [S].

    Returns (t [N], idx [N] int32, hit [N] bool).
    """
    oc = o[:, None, :] - centers[None, :, :]  # [N,S,3]
    # explicit x+y+z sum order: bit-parity with the CPU oracle's math
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    b = oc[:, :, 0] * d[:, None, 0] + oc[:, :, 1] * d[:, None, 1] + oc[:, :, 2] * d[:, None, 2]
    c = (oc[:, :, 0] * oc[:, :, 0] + oc[:, :, 1] * oc[:, :, 1] + oc[:, :, 2] * oc[:, :, 2]
         - (radii * radii)[None, :])
    return _select_roots(a, b, c, valid, tmin, tmax, exact_div=True)


def intersect_matmul(o, d, centers_t, radii_sq_c, valid, tmin, tmax):
    """Matrix-product form. centers_t: [3,S] (transposed); radii_sq_c: [S] = |c|^2 - r^2.

    b = o.d - c.d ; c_term = |o|^2 - 2 o.c + (|c|^2 - r^2); a = d.d.
    The two [N,3]@[3,S] contractions are matrix products; everything
    else is elementwise and fuses.
    """
    od = jnp.sum(o * d, axis=1, keepdims=True)  # [N,1]
    oo = jnp.sum(o * o, axis=1, keepdims=True)  # [N,1]
    a = jnp.sum(d * d, axis=1, keepdims=True)  # [N,1]
    # precision=HIGHEST: the default (TF32 on the GPU) loses ~2^-11 relative
    # on the big ground-sphere terms, which puts bounce origins ~0.01 inside
    # the sphere and traps paths in self-intersection loops.
    cd = jnp.dot(d, centers_t, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)  # [N,S]
    co = jnp.dot(o, centers_t, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)  # [N,S]
    b = od - cd
    c = oo - 2.0 * co + radii_sq_c[None, :]
    return _select_roots(a, b, c, valid, tmin, tmax)


def _select_roots(a, b, c, valid, tmin, tmax, exact_div=False):
    """Root selection per shader.rint:32-39 + closest-hit argmin.

    ``exact_div=True`` divides by ``a`` like the GLSL; the fast path uses a
    reciprocal multiply (one divide per ray instead of two per pair)."""
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
    if exact_div:
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
    else:
        inv_a = 1.0 / a
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
    t1_ok = ok & (t1 >= tmin) & (t1 <= tmax)
    t2_ok = ok & (t2 >= tmin) & (t2 <= tmax)
    t = jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, BIG))
    t = jnp.where(valid[None, :], t, BIG)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_min_val = jnp.min(t, axis=1)
    hit = t_min_val < BIG
    return t_min_val, idx, hit
