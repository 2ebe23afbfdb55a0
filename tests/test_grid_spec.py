"""The grid march finds brute force's closest hit.

``wavefront.grid_hit`` tests the global spheres, then marches the (x, z)
cells and tests each cell's candidates until the next crossing lies beyond
the best hit.  For any ray, the winner and its t must equal
``intersect_bruteforce`` over all spheres bit for bit: same quadratic, same
lowest-index tie-break.
"""

import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu.config import MAX_RAY_COLLISION_DISTANCE, T_MIN
from raytrace_tpu.models.scene import (generate_random_scene,
                                       random_sphere_field)
from raytrace_tpu.ops import wavefront as wf
from raytrace_tpu.ops.intersect import intersect_bruteforce
from raytrace_tpu.ops.trace import prepare_scene, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera

SCENES = {
    "book": lambda: generate_random_scene(0.0),
    "dense": lambda: random_sphere_field(2000, seed=1, extent=7.0),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_march_matches_bruteforce_bitwise(scene, n=512):
    ds = prepare_scene(SCENES[scene]())
    g = jax.tree.map(jnp.asarray, ds.grid)
    vp = viewport_arrays(reference_camera(), 32, 16)
    lane = jnp.arange(n, dtype=jnp.int32)
    st = wf.init_lanes(lane, jnp.ones((n,), bool), wf.call_scalars(1, 0, 0, 0, 0),
                       wf.viewport_vector(vp), 32)
    # random bounce-like rays from points scattered over the field
    rng = np.random.default_rng(0)
    o = rng.uniform([-11, 0.05, -11], [11, 3, 11], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = st._replace(ox=o[:, 0], oy=o[:, 1], oz=o[:, 2],
                     dx=d[:, 0], dy=d[:, 1], dz=d[:, 2])
    t, idx, hit, done, _ = jax.jit(
        lambda st: wf.grid_hit(st, g.gtab, g.cellf, g.cellid, g.cellcnt,
                               g.gscal, div=operator.truediv))(st)
    assert np.asarray(done).all()  # one call resolves every segment
    bt, bidx, bhit = jax.jit(intersect_bruteforce)(
        o, d, ds.centers, ds.radii, ds.valid, jnp.float32(T_MIN),
        jnp.float32(MAX_RAY_COLLISION_DISTANCE))
    hit = np.asarray(hit)
    assert np.array_equal(hit, np.asarray(bhit))
    assert np.array_equal(np.asarray(t), np.asarray(bt))
    assert np.array_equal(np.asarray(idx)[hit], np.asarray(bidx)[hit])
    assert hit.mean() > 0.5  # most rays hit something
