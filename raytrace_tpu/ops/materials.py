"""Branchless material scatter — vectorized closest-hit shading.

Replaces the reference closest-hit shader (/root/reference/shaders/shader.rchit)
with mask-selected math over lane arrays (one array per vector component, so
the same code runs on XLA arrays and on a Pallas kernel's lane blocks): all
three material models are evaluated (cheap, elementwise) and the per-lane
result is chosen by material code — a select over all materials instead of
a branch per material.

RNG parity: the reference consumes a data-dependent number of LCG draws per
hit (diffuse 3, metal 3, refractive 1-if-canRefract, miss 0 — see
shader.rchit:68-100 and note GLSL && short-circuits).  We draw speculatively
from the carried seed and commit the per-slot seed advance that matches the
material actually hit, preserving the exact reference stream.
"""

from __future__ import annotations

import operator

import jax.numpy as jnp

from . import rng as rngops
from ..models.scene import DIFFUSE, METAL, REFRACTIVE, CHECKERED


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]  # explicit x+y+z order


def normalize3(v, div):
    s = jnp.sqrt(dot3(v, v))
    return [div(v[0], s), div(v[1], s), div(v[2], s)]


def texture_color(p, tex, c0, c1):
    """getTextureColor, shader.rchit:53-64 (3-D sine checker, size 6).
    ``p``, ``c0``, ``c1``: per-component lists of lane arrays."""
    sines = (jnp.sin(6.0 * p[0]) * jnp.sin(6.0 * p[1])) * jnp.sin(6.0 * p[2])
    return [jnp.where(tex == CHECKERED, jnp.where(sines > 0.0, c0[c], c1[c]),
                      c0[c]) for c in range(3)]


def scatter(seed, d, n, front, mat, fuzz, div=operator.truediv):
    """getScatterDirection (shader.rchit:66-116) for every lane.

    ``d`` (unit ray direction) and ``n`` (normal facing the ray) are
    per-component lists of lane arrays; ``seed`` u32, ``front`` bool,
    ``mat`` i32, ``fuzz`` f32 (metal fuzz / refraction index).  ``div(a,
    b)`` replaces ``a / b`` (ops/wavefront.py).  Returns (new_seed,
    scatter direction [3 arrays], does_scatter).  Lanes that missed must
    mask the result and the seed advance themselves.
    """
    # speculative draws from the common seed; the material decides which
    # advance is committed
    seed3, ux, uy, uz = rngops.random_unit_vector(seed, div)
    unit = [ux, uy, uz]
    seed1, refr_rand = rngops.random_float(seed)

    # DIFFUSE — shader.rchit:68-76
    sd_d = [n[c] + unit[c] for c in range(3)]
    near0 = ((jnp.abs(sd_d[0]) < 1e-8) & (jnp.abs(sd_d[1]) < 1e-8)
             & (jnp.abs(sd_d[2]) < 1e-8))
    sd_d = [jnp.where(near0, n[c], sd_d[c]) for c in range(3)]

    # METAL — shader.rchit:78-89; reflect(I,N) = I - 2 dot(N,I) N
    ndi = dot3(n, d)
    refl = [d[c] - 2.0 * ndi * n[c] for c in range(3)]
    sd_m = normalize3([refl[c] + fuzz * unit[c] for c in range(3)], div)
    metal_scatters = dot3(sd_m, n) > 0.0

    # REFRACTIVE — shader.rchit:91-100.  canRefract computes
    # sqrt(1 - cosTheta^2) WITHOUT clamping (shader.rchit:126-129): if
    # cosTheta^2 > 1 the sqrt is NaN and the <= comparison is false, exactly
    # like GLSL/IEEE — do not clamp, or the draw-count stream diverges.
    eta = jnp.where(front, div(jnp.float32(1.0), fuzz), fuzz)
    cos_t = dot3([-d[0], -d[1], -d[2]], n)
    can_refract = (eta * jnp.sqrt(1.0 - cos_t * cos_t)) <= 1.0
    r0 = div(1.0 - eta, 1.0 + eta) ** 2
    om = 1.0 - cos_t  # >= 0 whenever can_refract holds
    pow5 = om * om
    pow5 = pow5 * pow5 * om
    reflectance = r0 + (1.0 - r0) * pow5
    does_refract = can_refract & (reflectance < refr_rand)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    sqk = jnp.sqrt(jnp.maximum(k, 0.0))
    sd_r = [jnp.where(does_refract, eta * d[c] - (eta * ndi + sqk) * n[c],
                      refl[c]) for c in range(3)]

    is_diffuse = mat == DIFFUSE
    is_metal = mat == METAL
    sd = [jnp.where(is_diffuse, sd_d[c], jnp.where(is_metal, sd_m[c], sd_r[c]))
          for c in range(3)]
    does_scatter = jnp.where(is_metal, metal_scatters, True)
    # seed advance: diffuse/metal 3 draws; refractive 1 if canRefract else 0
    new_seed = jnp.where(mat == REFRACTIVE,
                         jnp.where(can_refract, seed1, seed), seed3)
    return new_seed, sd, does_scatter
