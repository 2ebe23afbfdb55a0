"""Counter/stream RNG ops, bit-exact with the reference device RNG.

Reference: /root/reference/shaders/random.glsl —
``getRandomSeed`` (TEA 16-round hash, :1-13), ``randomInt`` (LCG
``seed = 1664525*seed + 1013904223``, :15-18), ``randomFloat`` (24-bit
mantissa, :20-22), ``randomUnitVector`` (normalize of uniform-in-cube, :32-34 —
deliberately NOT uniform on the sphere; reproduced faithfully).

All functions are elementwise over uint32 arrays and work identically on numpy
and jax.numpy inputs (integer arithmetic wraps mod 2^32 in both), so the CPU
oracle and the device wavefront share one RNG implementation and produce
bit-identical draw streams.

A per-ray LCG seed is *carried state* in the wavefront loop, exactly like the
``inout uint seed`` payload field in GLSL — this is what lets device output match
the Vulkan renderer near-bitwise rather than only statistically.
"""

from __future__ import annotations

import numpy as np

_U = np.uint32


def _sqrt(x):
    """sqrt that works on both numpy values and (possibly traced) jax arrays."""
    if isinstance(x, (np.ndarray, np.generic, float, int)):
        return np.sqrt(x)
    import jax.numpy as jnp

    return jnp.sqrt(x)


def tea_hash(val0, val1):
    """getRandomSeed — TEA 16 rounds (random.glsl:1-13). Elementwise uint32."""
    with np.errstate(over="ignore"):  # uint32 wrap is the intended semantics
        v0 = val0 + _U(0) * val1  # broadcast to common shape
        v1 = val1 + _U(0) * val0
        for n in range(16):
            s0 = _U(((n + 1) * 0x9E3779B9) & 0xFFFFFFFF)
            v0 = v0 + ((((v1 << _U(4)) + _U(0xA341316C)) ^ (v1 + s0)) ^ ((v1 >> _U(5)) + _U(0xC8013EA4)))
            v1 = v1 + ((((v0 << _U(4)) + _U(0xAD90777D)) ^ (v0 + s0)) ^ ((v0 >> _U(5)) + _U(0x7E95761E)))
        return v0


def lcg_next(seed):
    """randomInt — LCG step (random.glsl:15-18)."""
    with np.errstate(over="ignore"):  # uint32 wrap is the intended semantics
        return seed * _U(1664525) + _U(1013904223)


def random_float(seed):
    """randomFloat (random.glsl:20-22). Returns (new_seed, f32 in [0,1)).

    The u32->f32 cast goes through i32 (exact: the mask keeps 24 bits)."""
    seed = lcg_next(seed)
    masked = seed & _U(0x00FFFFFF)
    if isinstance(masked, (np.ndarray, np.generic)):
        f = masked.astype(np.int32).astype(np.float32)
    else:
        import jax.numpy as jnp

        f = masked.astype(jnp.int32).astype(jnp.float32)
    # * 2^-24 is bit-identical to / 2^24 and needs no division unit
    return seed, f * np.float32(2.0 ** -24)


def random_in_interval(seed, lo, hi):
    """randomInInterval (random.glsl:24-26)."""
    seed, r = random_float(seed)
    return seed, r * (np.float32(hi) - np.float32(lo)) + np.float32(lo)


def random_vector3(seed, lo, hi):
    """randomVector (random.glsl:28-30): three sequential draws -> [..., 3]."""
    seed, x = random_in_interval(seed, lo, hi)
    seed, y = random_in_interval(seed, lo, hi)
    seed, z = random_in_interval(seed, lo, hi)
    return seed, x, y, z


def random_unit_vector(seed, div=None):
    """randomUnitVector (random.glsl:32-34): normalize(uniform in [-1,1]^3).

    Faithful to the reference's corner-biased distribution (SURVEY.md C13).
    ``div(a, b)`` replaces ``a / b`` (see ops/wavefront.py).
    Returns (new_seed, x, y, z).
    """
    seed, x, y, z = random_vector3(seed, -1.0, 1.0)
    # GLSL normalize: v / length(v); length 0 -> inf/nan propagates (never
    # observed in practice: P(all three draws exactly 0) ~ 2^-72).
    n = _sqrt(x * x + y * y + z * z)
    inv = np.float32(1.0) / n if div is None else div(np.float32(1.0), n)
    return seed, x * inv, y * inv, z * inv


