"""raytrace_tpu — a path-tracing framework in JAX (XLA + Pallas).

Brand-new implementation of the capabilities of water-chika/ray-tracing-gpu-vulkan
(Vulkan hardware ray tracing of the *Ray Tracing in One Weekend* final scene with
multi-GPU image-split parallelism and a dynamic workload tuner):

- the Vulkan RT pipeline (rgen/rint/rchit/rmiss + BLAS/TLAS) becomes a
  *persistent-wavefront* loop: every pixel owns a lane, terminated paths
  immediately regenerate the pixel's next sample in place, so shapes stay static
  and lanes stay busy (``ops/trace.py``, ``ops/wavefront.py``);
- hardware AS traversal becomes a uniform-grid DDA, run on the GPU as one
  Pallas-Triton kernel that keeps every lane's state in registers
  (``models/grid.py``, ``ops/gridkernel.py``), with brute-force ray-vs-all-
  spheres XLA paths for scenes without a grid (``ops/intersect.py``);
- multi-GPU row-band splitting + the workload auto-tuner become
  ``jax.sharding.Mesh`` + ``shard_map`` over pixel rows (``parallel/``);
- the GLSL TEA+LCG RNG is reproduced bit-exactly so output can be validated
  near-bitwise against the CPU oracle (``ops/rng.py``, ``oracle/``).

Public API mirrors the reference C ABI (/root/reference/src/ray_trace.h:9-15).
"""

import os as _os

import jax as _jax

# Persistent XLA compile cache.  JAX_COMPILATION_CACHE_DIR, when set, is
# JAX's own setting and wins; a directory the embedding program configured
# (the test suite does) is kept; otherwise compiled programs go to one
# fixed directory inside the checkout.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or _jax.config.jax_compilation_cache_dir):
    _os.makedirs(CACHE_DIR, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from .config import RenderCallInfo, RenderConfig
from .models.scene import generate_random_scene, three_sphere_scene, SceneArrays
from .api import ray_trace, render_image

__version__ = "0.1.0"

__all__ = [
    "RenderCallInfo",
    "RenderConfig",
    "SceneArrays",
    "generate_random_scene",
    "three_sphere_scene",
    "ray_trace",
    "render_image",
    "__version__",
]
