"""Q5 measurement: f32 vs f64 accumulation error at 1080p / 10k spp.

The reference sums samples in dvec3 (shader.rgen:55, forcing shaderFloat64);
we accumulate f32 on device.  This renders the full benchmark twice with
IDENTICAL RNG streams — (a) device-f32 carried accumulator, (b) float64
host-side summation of 1000-spp chunks (accum_dtype=float64) — so the only
difference is summation precision.  Records the numbers for
docs/PARITY.md.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from raytrace_tpu.config import RenderConfig
from raytrace_tpu.ops.image import accum_to_u8
from raytrace_tpu.runtime.renderer import Renderer

W, H = int(os.environ.get("F64_W", 1920)), int(os.environ.get("F64_H", 1080))
SPP = int(os.environ.get("F64_SPP", 10000))


def run(dtype):
    cfg = RenderConfig(samples=SPP, width=W, height=H, samples_per_call=1000,
                       accum_dtype=dtype)
    r = Renderer(cfg)
    t0 = time.perf_counter()
    accum, total = r.render(SPP)
    accum = np.asarray(accum)
    print(f"{dtype}: {time.perf_counter()-t0:.1f}s", flush=True)
    return accum, total


a32, n = run("float32")
a64, _ = run("float64")
a32d = a32.astype(np.float64)
lin_rel = np.abs(a32d - a64) / np.maximum(np.abs(a64), 1e-12)
u32_img = np.asarray(accum_to_u8(a32, n), np.int32)
u64_img = np.asarray(accum_to_u8(a64, n), np.int32)
du8 = np.abs(u32_img - u64_img)
print(f"linear: max_rel={lin_rel.max():.3e} mean_rel={lin_rel.mean():.3e}", flush=True)
print(f"display u8: differing px={(du8.max(axis=2) > 0).sum()}/{W*H} "
      f"max|d|={du8.max()}", flush=True)
