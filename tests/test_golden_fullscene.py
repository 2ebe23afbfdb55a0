"""Full-scene regression golden: 488-sphere scene vs a stored oracle render.

The stored array was produced by oracle/cpu_reference.py (GLSL-semantics
straight-line model) at 24x14, 2 spp, depth 12, t=0 — it pins scene
generation (mt19937 layout), camera, RNG streams, and all three materials in
one artifact.  Regenerate with tests/data/README if semantics intentionally
change.
"""

import os

import numpy as np
import pytest

from raytrace_tpu.models.scene import generate_random_scene
from raytrace_tpu.ops.trace import prepare_scene, render_band, viewport_arrays
from raytrace_tpu.runtime.renderer import reference_camera

W, H, SPP, DEPTH = 24, 14, 2, 12
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_fullscene_24x14_2spp_d12.npy")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _render(backend, m=1):
    ds = prepare_scene(generate_random_scene(0.0))
    vp = viewport_arrays(reference_camera(), W, H)
    out = render_band(
        ds, vp, band_h=H, width=W, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(SPP), number=np.uint32(0),
        max_depth=DEPTH, backend=backend, pixels_per_lane=m,
        interpret=backend == "grid")
    return np.asarray(out)


def _near_bitwise(out, golden, allow_chaotic=3):
    # with 488 spheres a handful of pixels sit on fp-chaotic boundaries
    # (grazing hits / checker zero-crossings) where XLA's fma contraction
    # rounds differently than the numpy oracle; everything else must match
    bad = int((np.abs(out - golden).max(axis=2) > 1e-4).sum())
    assert bad <= allow_chaotic, f"{bad} pixels off (allow {allow_chaotic})"


def test_bruteforce_matches_golden(golden):
    _near_bitwise(_render("bruteforce"), golden)


def test_grid_matches_golden(golden):
    _near_bitwise(_render("grid", m=3), golden)


def test_matmul_statistical(golden):
    out = _render("matmul")
    # fp-ordering differences decorrelate chaotic pixels; bulk must agree
    close = np.abs(out - golden).max(axis=2) < 0.05
    assert close.mean() > 0.80
    assert abs(out.mean() - golden.mean()) / golden.mean() < 0.1
