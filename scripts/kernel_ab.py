"""Time render backends against each other end to end, in turns.

    python scripts/kernel_ab.py --spp 256 --variants grid,matmul
    python scripts/kernel_ab.py --spp 64 --variants grid:4,grid:16,grid:64

Each variant is ``backend`` or ``backend:M`` (pixels per lane; default:
the device profile's choice).  All variants render the book scene at
``--width`` x ``--height`` through ``Renderer.render_call`` in one process,
compiled up front (compilation is outside the timed window); then every
round times each variant once, in forward order on even rounds and reverse
order on odd ones (A B B A), and the medians are printed.  A time ends with
the image fetched to the host.  Needs an accelerator: on the CPU it exits
non-zero without timing anything.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--mode", default="exact")
    ap.add_argument("--variants", default="grid,matmul")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kernel_ab.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.models.scene import generate_random_scene
    from raytrace_tpu.runtime.renderer import Renderer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    scene = generate_random_scene(0.0)
    renderers = {}
    for v in args.variants.split(","):
        backend, _, m = v.partition(":")
        cfg = RenderConfig(samples=args.spp, width=args.width,
                           height=args.height, backend=backend,
                           mode=args.mode,
                           pixels_per_lane=int(m) if m else None)
        r = Renderer(cfg, scene=scene)
        t0 = time.perf_counter()
        np.asarray(r.render_call(1))
        print(f"{v}: backend {r.backend}, M={r.pixels_per_lane}, "
              f"{r.chunk_rows} rows per band, compile+1spp "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        renderers[v] = r
    times = {v: [] for v in renderers}
    order = list(renderers)
    for rnd in range(args.rounds):
        for v in order if rnd % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            img = np.asarray(renderers[v].render_call(args.spp))
            times[v].append(time.perf_counter() - t0)
            print(f"round {rnd} {v}: {times[v][-1]:.4f}s mean "
                  f"{float(img.mean()) / args.spp:.5f}", flush=True)
    print(json.dumps({
        "spp": args.spp, "size": [args.width, args.height],
        "mode": args.mode, "device": dev.device_kind,
        "median_s": {v: statistics.median(t) for v, t in times.items()},
        "runs_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
