"""Workload tuner tests: algorithm behavior + native/Python bit-exactness."""

import os
import shutil
import subprocess

import pytest

from raytrace_tpu.runtime.tuner import PyTuner, NativeTuner, default_lib_path, make_tuner


def _ensure_native():
    path = default_lib_path()
    if not os.path.exists(path):
        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("native toolchain unavailable")
        subprocess.run(
            ["make", "-C", os.path.dirname(os.path.dirname(path))], check=True,
            capture_output=True)
    return path


def test_redistribution_on_high_variance():
    # note: with the reference's variance metric (sum of squared relative
    # deviations, threshold 1.8) two devices can only trigger redistribution
    # past a ~37x speed ratio; three devices with one 10x-slow trigger it.
    t = PyTuner(total=120, devices=3)
    t.add_frame([40, 40, 40], duration=10.0, est=[10.0, 1.0, 1.0])
    out = t.get_workload()
    assert out is not None
    assert sum(out) == 120
    assert out[1] > out[0] and out[2] > out[0]  # faster devices get more rows
    # throughputs 4:40:40 -> device 0 gets ~5-6 rows
    assert out[0] <= 8


def test_balanced_leads_to_hillclimb_or_converge():
    t = PyTuner(total=100, devices=4, seed=12345)
    t.add_frame([25, 25, 25, 25], duration=1.0, est=[1.0, 1.0, 1.01, 0.99])
    seen_none = False
    seen_move = False
    for _ in range(20):
        out = t.get_workload()
        if out is None:
            seen_none = True
        else:
            assert sum(out) == 100
            diffs = sum(abs(a - b) for a, b in zip(out, [25, 25, 25, 25]))
            assert diffs in (0, 2)  # at most one row moved
            seen_move = True
    assert seen_none and seen_move  # 1/3 vs 2/3 branches both hit


def test_history_cap():
    t = PyTuner(total=10, devices=2)
    for i in range(30):
        t.add_frame([5, 5], duration=1.0 + i, est=[1.0, 1.0])
    assert len(t.frames) <= 12


def test_native_matches_python_bitwise():
    _ensure_native()
    seed = 0xDEADBEEF12345678
    py = PyTuner(total=1080, devices=3, seed=seed)
    nt = NativeTuner(total=1080, devices=3, seed=seed)
    frames = [
        ([360, 360, 360], 2.0, [1.0, 1.0, 4.0]),
        ([120, 480, 480], 1.2, [1.1, 1.2, 1.15]),
        ([121, 479, 480], 1.19, [1.15, 1.18, 1.16]),
    ]
    for dist, dur, est in frames:
        py.add_frame(dist, dur, est)
        nt.add_frame(dist, dur, est)
        for _ in range(5):
            assert py.get_workload() == nt.get_workload()


def test_make_tuner_returns_something():
    t = make_tuner(100, 2)
    t.add_frame([50, 50], 1.0, [1.0, 1.0])
    t.get_workload()  # must not raise
