"""Numeric validation of the compiled backends on the live device.

The pytest suite runs the grid kernel in interpret mode on the CPU, where it
is the same jnp code as ``bruteforce``; this module checks what the card's
compilers make of it.  On the GPU, Triton and XLA contract multiply-adds
into FMAs in different places and libdevice's sin differs from XLA's by
ulps, so a few fp-chaotic pixels (grazing hits, checker seams) flip while
the bulk agrees.  Each check therefore reports both the flipped-pixel count
(a tolerance, stated with its reason) and the statistical comparator of
utils/compare.py.  Used by chip_smoke.py; the CPU tests run each check
with the kernel interpreted (tests/conftest.py ``interpret_kernel``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

W, H, SPP, DEPTH = 24, 14, 2, 12
_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data")
GOLDEN = os.path.join(_DATA, "golden_fullscene_24x14_2spp_d12.npy")
# multi-block config: 9216 lanes at pixels_per_lane=1 spans many kernel
# programs (and the partial last block)
GOLDEN_MT = os.path.join(_DATA, "golden_fullscene_128x72_2spp_d8.npy")
BAD_PX_ATOL = 1e-3  # a pixel "differs" when a channel sum moves past this


def _fast_rr():
    from .. import config as _cfg

    return (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN)


def _render(backend: str, w: int, h: int, depth: int, spp: int, m: int,
            rr=None, y0: int = 0,
            band_h: Optional[int] = None, scene=None):
    from ..models.scene import generate_random_scene
    from ..ops.trace import prepare_scene, render_band, viewport_arrays
    from .renderer import reference_camera

    ds = prepare_scene(scene if scene is not None
                       else generate_random_scene(0.0))
    vp = viewport_arrays(reference_camera(), w, h)
    return np.asarray(render_band(
        ds, vp, band_h=h if band_h is None else band_h, width=w,
        y0=np.int32(y0), seed_y0=np.int32(y0), offset_x=np.int32(0),
        spp=np.int32(spp), number=np.uint32(0), max_depth=depth,
        backend=backend, pixels_per_lane=m, rr=rr))


def _render_golden_config(backend: str, multi_tile: bool, m=None, rr=None,
                          spp: int = SPP):
    if multi_tile:
        w, h, depth = 128, 72, 8
        m = 1 if m is None else m
    else:
        w, h, depth = W, H, DEPTH
        m = 3 if m is None else m
    out = _render(backend, w, h, depth, spp, m, rr=rr)
    return out, (w, h)


def _diff_stats(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a - b).max(axis=2)
    return {"diff_px": int((diff > 0).sum()),
            "bad_px": int((diff > BAD_PX_ATOL).sum()),
            "total_px": int(diff.size),
            "max_diff": float(diff.max())}


def golden_check(backend: str = "grid", golden_path: Optional[str] = None,
                 multi_tile: bool = False, mode: str = "exact") -> dict:
    """Render the golden config with ``backend`` on the live platform and
    compare against the stored CPU-oracle artifact.

    Pass criterion: the statistical comparator's ``matches()`` — per-tile
    z-scores within sampling error AND <2% mean shift; the flipped-pixel
    counts are reported beside it.
    """
    from ..utils.compare import compare_accums

    golden = np.load(golden_path or (GOLDEN_MT if multi_tile else GOLDEN))
    out, _ = _render_golden_config(
        backend, multi_tile, rr=_fast_rr() if mode == "fast" else None)
    # the tile size must DIVIDE the golden dims or compare_accums silently
    # crops the remainder out of the z gate: 8 | (128, 72); 2 | (24, 14)
    res = compare_accums(out, golden, SPP, SPP, tile=8 if multi_tile else 2)
    return {
        "check": f"{backend}==oracle golden",
        "mode": mode,
        **_diff_stats(out, golden),
        "mean_rel": round(res.mean_rel_diff, 6),
        "tile_p95_z": round(res.tile_p95_z, 3),
        "psnr_db": round(res.psnr_db, 2),
        "ok": bool(res.matches()),
    }


FAST_CHECK_SPP = 64  # at 2 spp the gate has no power against a mildly
# biased RR implementation (noise against noise); at 64 spp the per-tile
# z-gate's sampling noise is ~5.7x smaller while a bias term is unchanged


def fast_check(spp: int = FAST_CHECK_SPP, backend: str = "grid") -> dict:
    """Fast (Russian-roulette) vs exact mode on the live platform, compared
    statistically on the multi-block golden config at ``spp`` samples —
    the check that the fast estimator is unbiased.  The PSNR is that of
    two independent 64-spp estimates of the same image, so it measures
    their noise, not an error."""
    from ..utils.compare import compare_accums

    exact, _ = _render_golden_config(backend, multi_tile=True, spp=spp)
    fast, _ = _render_golden_config(backend, multi_tile=True, rr=_fast_rr(),
                                    spp=spp)
    res = compare_accums(fast, exact, spp, spp, tile=8)
    return {
        "check": f"{backend} fast==exact (statistical)",
        "rr": list(_fast_rr()),
        "spp": spp,
        "mean_rel": round(res.mean_rel_diff, 6),
        "tile_p95_z": round(res.tile_p95_z, 3),
        "psnr_db": round(res.psnr_db, 2),
        "ok": bool(res.matches()),
    }


def bandsplit_check(backend: str = "grid", n_bands: int = 4) -> dict:
    """Row-band split vs whole-frame render on the live platform, compared
    bitwise.  This is the multi-device data-parallel claim — an N-device
    shard_map render runs exactly these per-band programs
    (parallel/sharding.py global-seed mode; ray_trace.cpp:74-105 banding
    analogue).  A lane's arithmetic does not depend on the band's shape,
    so the split is expected to be bit-identical."""
    w, h, depth = 128, 72, 8
    assert h % n_bands == 0
    bh = h // n_bands
    whole = _render(backend, w, h, depth, SPP, 1)
    split = np.concatenate(
        [_render(backend, w, h, depth, SPP, 1, y0=i * bh, band_h=bh)
         for i in range(n_bands)], axis=0)
    stats = _diff_stats(whole, split)
    return {"check": f"{backend} bandsplit({n_bands})==whole",
            **stats, "bit_identical": stats["diff_px"] == 0,
            "ok": stats["diff_px"] == 0}


def backend_check(backend_a: str = "grid", backend_b: str = "bruteforce",
                  mode: str = "exact", scene=None, size=(128, 72),
                  depth: int = 8, spp: int = SPP,
                  bad_frac: float = 0.01) -> dict:
    """Render one config through ``Renderer`` with two backends on the live
    platform (brute force in memory-bounded bands; ``auto`` resolves as
    for users) and compare pixel by pixel: at most ``bad_frac`` of the
    pixels may move past BAD_PX_ATOL (fp-chaotic pixels: the two compilers
    round differently), and the statistical comparator must match."""
    from ..config import RenderConfig
    from ..models.scene import generate_random_scene
    from ..utils.compare import compare_accums
    from .renderer import Renderer

    scene = scene if scene is not None else generate_random_scene(0.0)
    w, h = size
    outs, names = [], []
    for b in (backend_a, backend_b):
        r = Renderer(RenderConfig(samples=spp, width=w, height=h,
                                  max_depth=depth, backend=b, mode=mode,
                                  pixels_per_lane=1),
                     scene=scene)
        outs.append(np.asarray(r.render_call(spp)))
        names.append(r.backend)
    a, b = outs
    stats = _diff_stats(a, b)
    tile = 8 if w % 8 == 0 and h % 8 == 0 else 2
    res = compare_accums(a, b, spp, spp, tile=tile)
    return {
        "check": f"{names[0]}=={names[1]}",
        "mode": mode,
        **stats,
        "bad_frac_limit": bad_frac,
        "mean_rel": round(res.mean_rel_diff, 6),
        "tile_p95_z": round(res.tile_p95_z, 3),
        "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
        "ok": bool(stats["bad_px"] <= bad_frac * stats["total_px"]
                   and res.matches() and np.isfinite(a).all()),
    }
