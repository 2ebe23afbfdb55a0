"""Benchmark harness — prints ONE JSON line.

Metric: seconds to render the final book scene (488 spheres) at 1920x1080
with 10,000 samples/pixel through ``Renderer`` on the backend ``auto``
picks — the reference README's benchmark (12.5 s on a Radeon RX 6800 XT,
the reference's README.md:62).  Compilation is a warm-up call outside the
timed window.  The run needs an NVIDIA GPU: without one it exits non-zero
and prints no result.

Env knobs: BENCH_WIDTH/BENCH_HEIGHT/BENCH_SPP/BENCH_BACKEND/BENCH_MODE.
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_S = 12.5  # reference 10k spp @1080p, RX 6800 XT


def main() -> int:
    import jax
    import numpy as np

    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.runtime.renderer import Renderer

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("BENCH_SPP", 10000))
    cfg = RenderConfig(samples=spp, width=width, height=height,
                       backend=os.environ.get("BENCH_BACKEND", "auto"),
                       mode=os.environ.get("BENCH_MODE", "exact"))
    r = Renderer(cfg)
    t0 = time.perf_counter()
    np.asarray(r.render_call(1))  # compile + first run
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = np.asarray(r.render_call(spp))
    value = time.perf_counter() - t0
    if not np.isfinite(img).all():
        print("bench.py: non-finite pixels in the render", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": f"seconds_{width}x{height}_{spp}spp",
        "value": value,
        "unit": "s",
        "baseline_s": BASELINE_S,
        "baseline_hw": "RX 6800 XT (reference README.md:62)",
        "compile_s": compile_s,
        "backend": r.backend,
        "mode": cfg.mode,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
