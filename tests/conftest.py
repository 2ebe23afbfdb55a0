"""Test harness config.

By default the suite runs on a deterministic 8-device CPU platform: the
virtual 8-device mesh is how multi-device sharding is validated without a
multi-GPU machine, and the grid kernel runs in Pallas interpret mode.
Tests marked ``gpu`` need the card: they skip here (the ``gpu_device``
fixture decides, at run time) and run on the card through
``python chip_smoke.py``, which sets RAYTRACE_TEST_DEVICE=gpu so this file
leaves the platform alone.
"""

import os
import pathlib

import pytest

ON_CARD = os.environ.get("RAYTRACE_TEST_DEVICE") == "gpu"

if not ON_CARD:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
    if "parallel_codegen" not in _flags:
        # XLA:CPU's parallel LLVM codegen has crashed nondeterministically
        # on the largest interpret-mode programs; single-split codegen
        # compiles slower but has not crashed
        _flags += " --xla_cpu_parallel_codegen_split_count=1"
    os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


# Persistent compile cache: the wavefront while-loop takes seconds to a
# minute to compile on the CPU.  JAX_COMPILATION_CACHE_DIR, when set, is
# JAX's own setting and wins; otherwise the cache lives in the checkout,
# keyed by this host's CPU feature flags: XLA's cache key does not include
# host machine features, so an entry compiled on another host can load
# here with different codegen (fma contraction differs) and break
# cross-graph bitwise tests.  A per-microarch subdirectory keeps every
# host self-consistent.  WRITES can be turned off (RAYTRACE_TESTS_CACHE_
# WRITES=0) because XLA:CPU executable serialization has crashed on large
# fresh executables (scripts/run_tests.sh retries with writes off).


def _host_tag():
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return platform.machine()


if not ON_CARD and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache = (pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
              / f"cpu-{_host_tag()}")
    _cache.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(_cache))
if os.environ.get("RAYTRACE_TESTS_CACHE_WRITES", "1") == "1":
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
else:  # reads only: nothing ever reaches the crashy serialize path
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)


@pytest.fixture
def gpu_device():
    """The card, for tests marked ``gpu``; skips where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform!r}); "
                    "run on the card with `python chip_smoke.py`")
    return dev


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Run every grid-kernel launch in the Pallas interpreter, for tests
    that reach the kernel through the renderers or runtime/validation.py,
    which have no interpret switch.  The jit caches are cleared on both
    sides, so an interpreted trace and a compiled-kernel trace of the same
    shapes never share a cache entry."""
    from raytrace_tpu.ops import gridkernel

    real = gridkernel.render_lanes

    def interpreted(*args, interpret=False, **kw):
        return real(*args, interpret=True, **kw)

    jax.clear_caches()
    monkeypatch.setattr(gridkernel, "render_lanes", interpreted)
    yield
    jax.clear_caches()
