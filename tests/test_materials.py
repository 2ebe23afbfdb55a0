"""Vectorized scatter (ops/materials.py) vs the straight-line oracle scatter.

Checks direction math, does-scatter flags, and — critical for stream parity —
the per-material LCG draw counts (shader.rchit consumes 3 draws for
diffuse/metal, 1-if-canRefract for glass)."""

import numpy as np
import jax.numpy as jnp

from raytrace_tpu.models.scene import SceneArrays, DIFFUSE, METAL, REFRACTIVE
from raytrace_tpu.ops import materials, rng as rngops
from raytrace_tpu.oracle import cpu_reference as oracle


def _mini_scene(mat, attr):
    s = 4
    return SceneArrays(
        centers=np.zeros((s, 3), np.float32),
        radii=np.ones((s,), np.float32),
        material=np.full((s,), mat, np.int32),
        texture=np.zeros((s,), np.int32),
        color0=np.ones((s, 3), np.float32) * 0.5,
        color1=np.ones((s, 3), np.float32),
        attr=np.full((s,), attr, np.float32),
        n_spheres=np.int32(s),
    )


def _random_dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = np.float32(rng.normal(0, 1, (n, 3)))
    return d / np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)


def _compare(mat, attr, seed_base=17):
    n = 256
    sc = _mini_scene(mat, attr)
    d = _random_dirs(n, seed_base)
    normal_raw = _random_dirs(n, seed_base + 1)
    # oracle convention: normal opposes d (front-face flip already applied)
    ddn = np.sum(d * normal_raw, axis=1, keepdims=True)
    normal = np.where(ddn < 0, normal_raw, -normal_raw).astype(np.float32)
    front = np.ones(n, bool) if mat != REFRACTIVE else (np.arange(n) % 2 == 0)
    seeds = rngops.tea_hash(np.arange(n, dtype=np.uint32), np.uint32(5))

    new_seed, sd, dsc = materials.scatter(
        jnp.asarray(seeds), [jnp.asarray(d[:, c]) for c in range(3)],
        [jnp.asarray(normal[:, c]) for c in range(3)],
        jnp.asarray(front), jnp.full((n,), mat, jnp.int32),
        jnp.full((n,), attr, jnp.float32))
    new_seed, dsc = np.asarray(new_seed), np.asarray(dsc)
    sd = np.stack([np.asarray(v) for v in sd], axis=1)

    for i in range(n):
        s, res = oracle._scatter(sc, 0, d[i], normal[i], bool(front[i]), seeds[i])
        assert int(s) == int(new_seed[i]), f"seed mismatch lane {i}"
        if res is None:
            assert not dsc[i], f"lane {i}: oracle absorbed, vector scattered"
        else:
            assert dsc[i]
            assert np.allclose(sd[i], res, atol=2e-5), (i, sd[i], res)


def test_diffuse():
    _compare(DIFFUSE, 0.0)


def test_metal_no_fuzz():
    _compare(METAL, 0.0)


def test_metal_fuzzy():
    _compare(METAL, 0.6)


def test_refractive():
    _compare(REFRACTIVE, 1.5)


def test_texture_checkered():
    point = np.float32([[0.1, 0.1, 0.1], [0.1, -0.1, 0.1], [4.0, 0.0, 2.0]])
    tex = np.int32([1, 1, 0])
    c0 = np.float32([[0.05] * 3] * 3)
    c1 = np.float32([[0.95] * 3] * 3)
    def cols(a):
        return [jnp.asarray(a[:, c]) for c in range(3)]

    out = np.stack([np.asarray(v) for v in materials.texture_color(
        cols(point), jnp.asarray(tex), cols(c0), cols(c1))], axis=1)
    # sin(0.6)^3 > 0 -> color0 ; flip one axis -> color1 ; solid -> color0
    assert np.allclose(out[0], 0.05)
    assert np.allclose(out[1], 0.95)
    assert np.allclose(out[2], 0.05)
