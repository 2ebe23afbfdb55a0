"""Workload auto-tuner — dynamic row-band load balancer.

Python binding for the native C++ tuner (native/tuner.cpp) with a bit-exact
pure-Python fallback.  Same algorithm as the reference's tune:: namespace
(/root/reference/src/workload_tuner.hpp:8-105, SURVEY.md C4):

1. relative variance of per-device busy times > 1.8 -> redistribute rows
   proportionally to measured throughput (rows/duration);
2. else w.p. 2/3: stochastic hill-climb — best distribution seen, move one
   row between two random devices;
3. else: converged (``None``).

On homogeneous devices the static equal split is already optimal; the
tuner exists for heterogeneity parity (mixed-generation pools, a card
throttling) and is exercised by the heterogeneous dispatch path in
``parallel/hetero.py``.

Unlike the reference (global ``rand()``), the RNG is an explicit seeded
xorshift64*, shared between the C++ and Python implementations, so both
produce identical decision streams (tested in tests/test_tuner.py).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

_M64 = (1 << 64) - 1


def _xorshift(s: int) -> tuple:
    s ^= s >> 12
    s ^= (s << 25) & _M64
    s ^= s >> 27
    return s, (s * 0x2545F4914F6CDD1D) & _M64


@dataclass
class _Frame:
    dist: List[int]
    duration: float
    est: List[float]


@dataclass
class PyTuner:
    """Pure-Python tuner (bit-exact with native/tuner.cpp)."""

    total: int
    devices: int
    seed: int = 0x9E3779B97F4A7C15
    frames: List[_Frame] = field(default_factory=list)

    def add_frame(self, dist: Sequence[int], duration: float, est: Sequence[float]):
        if len(self.frames) > 10:
            self.frames = [self.frames[-1]]
        self.frames.append(_Frame(list(dist), float(duration), list(est)))

    def _rng_below(self, n: int) -> int:
        self.seed, out = _xorshift(self.seed)
        return out % n

    def get_workload(self) -> Optional[List[int]]:
        if not self.frames or self.devices == 0:
            return None
        f = self.frames[-1]
        n = self.devices
        avg = sum(f.est) / n
        variance = 0.0
        if avg > 0:
            for e in f.est:
                v = (e - avg) / avg
                variance += v * v

        if variance > 1.8:
            vs = [
                (f.dist[i] / f.est[i]) if f.est[i] > 0 else 0.0 for i in range(n)
            ]
            total_v = sum(vs)
            if total_v <= 0:
                return None
            out = [int(self.total * vs[i] / total_v) for i in range(n)]
            remain = self.total - sum(out)
            for i in range(remain):
                out[i % n] += 1
            return out

        if self._rng_below(3) != 0:
            best = min(self.frames, key=lambda fr: fr.duration)
            out = list(best.dist)
            dec = self._rng_below(n)
            inc = self._rng_below(n)
            if out[dec] > 1:
                out[inc] += 1
                out[dec] -= 1
            return out

        return None


class NativeTuner:
    """ctypes wrapper over native/tuner.cpp (same contract as PyTuner)."""

    def __init__(self, total: int, devices: int, seed: int = 0, lib_path: Optional[str] = None):
        self._lib = ctypes.CDLL(lib_path or default_lib_path())
        self._lib.tuner_create.restype = ctypes.c_void_p
        self._lib.tuner_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
        self._lib.tuner_destroy.argtypes = [ctypes.c_void_p]
        self._lib.tuner_add_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        self._lib.tuner_get_workload.restype = ctypes.c_int
        self._lib.tuner_get_workload.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
        self._h = self._lib.tuner_create(total, devices, seed)
        self._n = devices

    def add_frame(self, dist, duration, est):
        d = (ctypes.c_uint32 * self._n)(*dist)
        e = (ctypes.c_double * self._n)(*est)
        self._lib.tuner_add_frame(self._h, d, duration, e)

    def get_workload(self):
        out = (ctypes.c_uint32 * self._n)()
        if self._lib.tuner_get_workload(self._h, out):
            return list(out)
        return None

    def __del__(self):
        try:
            self._lib.tuner_destroy(self._h)
        except Exception:
            pass


def default_lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "build", "libraytrace_tuner.so")


def make_tuner(total: int, devices: int, seed: int = 0x9E3779B97F4A7C15):
    """Native tuner when built, else the bit-exact Python fallback."""
    try:
        return NativeTuner(total, devices, seed)
    except OSError:
        return PyTuner(total, devices, seed)
