"""Runtime-layer tests: checkpoint/resume, profiling stats, renderer knobs."""

import numpy as np
import pytest

from raytrace_tpu.config import RenderConfig
from raytrace_tpu.models.scene import three_sphere_scene
from raytrace_tpu.runtime.profiling import FrameStats
from raytrace_tpu.runtime.renderer import Renderer

W, H = 32, 18


def _renderer(**kw):
    cfg = RenderConfig(width=W, height=H, max_depth=6, backend="matmul", **kw)
    return Renderer(cfg, scene=three_sphere_scene())


def test_checkpoint_roundtrip(tmp_path):
    r = _renderer()
    accum = np.asarray(r.render_call(2))
    p = str(tmp_path / "ckpt.npz")
    r.save_state(p, accum, samples_done=2, number=1)
    a2, done, num = r.load_state(p)
    assert np.array_equal(a2, accum) and done == 2 and num == 1


def test_checkpoint_resolution_mismatch(tmp_path):
    r = _renderer()
    p = str(tmp_path / "ckpt.npz")
    r.save_state(p, np.zeros((H, W, 3), np.float32), 1, 1)
    other = Renderer(
        RenderConfig(width=16, height=9, max_depth=6, backend="matmul"),
        scene=three_sphere_scene())
    with pytest.raises(ValueError):
        other.load_state(p)


def test_resumable_render_matches_uninterrupted(tmp_path):
    p = str(tmp_path / "ck.npz")
    r = _renderer(samples_per_call=2)
    full, _ = r.render_resumable(6)
    # interrupted run: 2 calls, checkpoint, new renderer resumes
    r2 = _renderer(samples_per_call=2)
    acc = None
    acc = r2.render_call(2, number=0, accum=acc)
    acc = r2.render_call(2, number=1, accum=acc)
    r2.save_state(p, acc, 4, 2)
    r3 = _renderer(samples_per_call=2)
    resumed, done = r3.render_resumable(6, checkpoint_path=p)
    assert done == 6
    assert np.allclose(np.asarray(resumed), np.asarray(full), atol=1e-5)


def test_frame_stats_adaptive_window():
    fs = FrameStats()
    with fs.frame():
        pass
    fs.durations[:] = [0.1]
    assert fs.adaptive_frame_count(4.0) == int((4.0 + 5.0) / 0.1)
    rep = fs.report()
    assert rep["frames"] == 1
    assert "duration_per_frame" in fs.dump()


def test_chunked_render_bitwise_equal():
    """Internal row chunking must be invisible (global seeds)."""
    r1 = _renderer()
    r1.chunk_rows = H  # single chunk
    a = np.asarray(r1.render_call(2))
    r2 = _renderer()
    r2.chunk_rows = 5  # 4 chunks incl. remainder
    b = np.asarray(r2.render_call(2))
    assert np.array_equal(a, b)


def test_camera_override_changes_view():
    base = _renderer()
    cfg = RenderConfig(width=W, height=H, max_depth=6, backend="matmul",
                       camera_pos=(0.0, 2.0, -20.0), camera_dir=(0.0, -2.0, 20.0))
    from raytrace_tpu.models.scene import three_sphere_scene
    moved = Renderer(cfg, scene=three_sphere_scene())
    a = np.asarray(base.render_call(2))
    b = np.asarray(moved.render_call(2))
    assert not np.array_equal(a, b)


def test_config_camera_defaults_to_reference():
    from raytrace_tpu.runtime.renderer import config_camera, reference_camera
    assert config_camera(RenderConfig()) == reference_camera()


def test_resumable_retries_on_device_fault(monkeypatch):
    """A failing render_call is retried without losing accumulated work."""
    r = _renderer(samples_per_call=2)
    calls = {"n": 0}
    orig = Renderer.render_call

    def flaky(self, spp, number=0, accum=None):
        calls["n"] += 1
        if calls["n"] == 2:  # fail once mid-render
            raise RuntimeError("device fault")
        return orig(self, spp, number=number, accum=accum)

    monkeypatch.setattr(Renderer, "render_call", flaky)
    accum, done = r.render_resumable(4)
    assert done == 4 and calls["n"] == 3
    clean = _renderer(samples_per_call=2)
    ref, _ = clean.render_resumable(4)
    assert np.allclose(accum, ref, atol=1e-5)


def test_resumable_gives_up_after_max_retries(monkeypatch):
    r = _renderer(samples_per_call=2)

    def broken(self, spp, number=0, accum=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(Renderer, "render_call", broken)
    with pytest.raises(RuntimeError):
        r.render_resumable(4, max_retries=1)


def test_device_trace_smoke(tmp_path):
    """jax.profiler trace context works around a render (SURVEY §5 gap)."""
    from raytrace_tpu.runtime.profiling import device_trace

    r = _renderer()
    with device_trace(str(tmp_path)):
        np.asarray(r.render_call(1))
    import os

    assert any(True for _ in os.scandir(tmp_path))  # trace files written


def test_accum_dtype_f64_matches_f32_statistically():
    """Q5 (shader.rgen:55 dvec3): float64 cross-call accumulation. At small
    sample counts f32 summation is near-exact, so the two modes must agree
    to f32 rounding; the dtype and per-call chunking must be honored."""
    r32 = _renderer(samples=8, samples_per_call=2)
    r64 = _renderer(samples=8, samples_per_call=2, accum_dtype="float64")
    a32, n32 = r32.render()
    a64, n64 = r64.render()
    assert n32 == n64 == 8
    assert isinstance(a64, np.ndarray) and a64.dtype == np.float64
    a32 = np.asarray(a32, np.float64)
    assert np.allclose(a32, a64, rtol=1e-5, atol=1e-6)
    # tonemap path accepts the f64 host accumulator
    from raytrace_tpu.ops.image import accum_to_u8

    u8 = accum_to_u8(a64, 8)
    assert u8.dtype == np.uint8 and u8.shape == (H, W, 3)


def test_accum_dtype_rejects_unknown():
    r = _renderer(accum_dtype="bfloat16")
    import pytest as _pytest

    with _pytest.raises(ValueError):
        r.render(2)


@pytest.mark.parametrize("backend", ["grid", "bruteforce"])
def test_golden_check_runs_on_cpu(backend, interpret_kernel):
    """validation.golden_check (chip_smoke.py's oracle check) passes on the
    CPU for the grid kernel (interpret mode) and its reference."""
    from raytrace_tpu.runtime.validation import golden_check

    res = golden_check(backend)
    assert res["ok"], res
    # multi-block config (many kernel programs and a partial last block)
    res = golden_check(backend, multi_tile=True)
    assert res["ok"], res


def test_pixels_per_lane_from_profile():
    """M comes from the device profile's lane target (CPU row here): a
    1080p frame aims at lanes_target lanes; an explicit config wins."""
    from raytrace_tpu.runtime.chips import profile_for

    prof = profile_for("cpu")
    r = Renderer(RenderConfig(samples=1, width=1920, height=1080,
                              backend="grid"))
    assert r.pixels_per_lane == 1920 * 1080 // prof.lanes_target
    assert r.chunk_rows == 1080  # the grid kernel takes the whole frame
    r2 = Renderer(RenderConfig(samples=1, width=1920, height=1080,
                               backend="grid", pixels_per_lane=63))
    assert r2.pixels_per_lane == 63


@pytest.mark.parametrize("backend,n_spheres,rows", [
    ("matmul", 512, 1080),      # 2^19 lanes x M=4 cover the frame
    ("matmul", 100_004, 5),     # 2684 lanes x 4 px / 1920 px per row
    ("bruteforce", 512, 34),    # [lanes, spheres, 3] bound: 16384 lanes
    ("grid", 100_004, 1080),    # no [lanes, spheres] intermediates
])
def test_band_rows_bound_brute_force(backend, n_spheres, rows):
    """Brute force bounds lanes x spheres per band, so a dense scene
    renders in more, smaller bands instead of exhausting device memory."""
    from raytrace_tpu.runtime.renderer import band_rows

    assert band_rows(backend, n_spheres, 1920, 1080, 4) == rows


@pytest.mark.parametrize("kind,substr", [
    ("NVIDIA H100 80GB HBM3", "H100"),
    ("NVIDIA H100 PCIe", "H100"),
    ("cpu", "cpu"),
])
def test_chip_profile_lookup(kind, substr):
    """Device-constant table (runtime/chips.py): known kinds resolve."""
    from raytrace_tpu.runtime.chips import profile_for

    assert profile_for(kind).kind_substr == substr


def test_chip_profile_unknown_kind_raises():
    from raytrace_tpu.runtime.chips import profile_for

    with pytest.raises(ValueError, match="no runtime profile"):
        profile_for("weird accelerator")
    assert profile_for(None) is not None  # the live device (CPU here)


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the package sets no cache
    directory of its own (JAX uses the variable); without it, compiled
    programs go to the checkout's .jax_cache."""
    import os
    import subprocess
    import sys

    import raytrace_tpu

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(raytrace_tpu.__file__))
    want = raytrace_tpu.CACHE_DIR
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, raytrace_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_backend_check_runs_on_cpu(mode, interpret_kernel):
    """validation.backend_check (chip_smoke.py's kernel-vs-reference
    check): on the CPU the interpret-mode kernel equals bruteforce."""
    from raytrace_tpu.runtime.validation import backend_check

    res = backend_check("grid", "bruteforce", mode=mode, size=(32, 16))
    assert res["ok"] and res["diff_px"] == 0, res
