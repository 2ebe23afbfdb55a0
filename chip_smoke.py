"""Smoke run of the path tracer on an NVIDIA GPU — the quickest proof that
the system starts on the card and renders correctly.

    python chip_smoke.py          # one card: all phases below
    python chip_smoke.py --four   # four cards: the row-band split only

One card:
  1. main path: the CLI in-process (``utils.cli.main``) renders the book
     scene at 1920x1080, 8 spp, ``--store``, in exact and in fast mode; the
     PNG is read back and checked; the band step's compile time, memory
     analysis and the backend ``auto`` picks are printed;
  2. the compiled kernel against the plain references on the card, each
     with its tolerance: bruteforce vs the CPU-oracle golden, the grid
     kernel vs bruteforce (exact and fast), the 100k-sphere field on
     ``auto``'s route vs chunked bruteforce, the band split vs the whole
     frame (bitwise) and fast vs exact (statistical);
  3. the served loop: ``LiveViewer`` renders the 1920x1080 book frame in
     progressive calls on an ephemeral port; a thread of this process
     fetches three distinct refinements over HTTP (``/state``'s sample
     count rises between them) and decodes them;
  4. the tests marked ``gpu`` (tests/test_gpu.py), in this process.
Four cards: ``MultiChipRenderer`` renders the book scene at 1920x1080,
8 spp, over 4 cards and must equal the one-card render bitwise; one
``HeteroRenderer.tune_round`` shows each band's output on its own card.

Every phase that fails makes the exit code non-zero.  Without a GPU the
script exits non-zero before printing any result.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

FAILURES = []
WIDTH, HEIGHT = 1920, 1080  # the reference's own frame (BASELINE.md)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail) -> None:
    log(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        FAILURES.append(name)


def phase(fn):
    """Run one phase; an exception fails it (and the run) with its text."""
    t0 = time.perf_counter()
    log(f"== {fn.__name__}")
    try:
        fn()
    except Exception as e:  # a failed phase must not stop the others
        check(fn.__name__, False, f"{type(e).__name__}: {e}")
    log(f"== {fn.__name__} done in {time.perf_counter() - t0:.1f}s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---- one card ---------------------------------------------------------------

def main_path() -> None:
    import jax

    from raytrace_tpu.models.scene import (generate_random_scene,
                                           random_sphere_field)
    from raytrace_tpu.ops.trace import (prepare_scene, render_band,
                                        viewport_arrays)
    from raytrace_tpu.runtime.renderer import (default_pixels_per_lane,
                                               reference_camera,
                                               resolve_backend)
    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.utils import cli
    from raytrace_tpu.utils.png import decode_png

    book = prepare_scene(generate_random_scene(0.0))
    field = prepare_scene(random_sphere_field(100_000, seed=1))
    log(f"auto backend: book scene -> {resolve_backend('auto', book)}, "
        f"100k field -> {resolve_backend('auto', field)}")
    check("auto picks the grid kernel for both scenes",
          resolve_backend("auto", book) == resolve_backend("auto", field)
          == "grid", "")

    # the band step the CLI compiles: its compile time and memory
    w, h = WIDTH, HEIGHT
    m = default_pixels_per_lane(RenderConfig(), w * h)
    vp = viewport_arrays(reference_camera(), w, h)
    t0 = time.perf_counter()
    compiled = render_band.lower(
        jax.device_put(book), jax.device_put(vp), band_h=h, width=w,
        y0=np.int32(0), seed_y0=np.int32(0), offset_x=np.int32(0),
        spp=np.int32(8), number=np.uint32(0), max_depth=50, backend="grid",
        pixels_per_lane=m).compile()
    log(f"band step (grid, {w}x{h}, M={m}): compile "
        f"{time.perf_counter() - t0:.2f}s, {compiled.memory_analysis()}")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    for mode in ("exact", "fast"):
        path = os.path.join(out_dir, f"book_{mode}.png")
        t0 = time.perf_counter()
        rc = cli.main(["--samples", "8", "--width", str(w), "--height",
                       str(h), "--store", "--out", path, "--mode", mode])
        secs = time.perf_counter() - t0
        img = decode_png(open(path, "rb").read())
        mean = float(img.mean())
        check(f"CLI {mode} {w}x{h} 8spp", rc == 0 and img.shape == (h, w, 3)
              and 40.0 < mean < 220.0,
              f"rc={rc} png {img.shape} mean {mean:.2f} (plausible: 40-220) "
              f"in {secs:.2f}s incl. compile")


def comparisons() -> None:
    from raytrace_tpu.models.scene import random_sphere_field
    from raytrace_tpu.runtime import validation as v

    log(f"tolerances: a pixel differs when a channel sum moves past "
        f"{v.BAD_PX_ATOL}; statistical gate = per-tile p95 z < 4 and mean "
        f"shift < 2% (utils/compare.py); f32 throughout, matrix products "
        f"at precision=HIGHEST")
    res = v.golden_check("bruteforce", multi_tile=True)
    check("bruteforce vs CPU-oracle golden (128x72 2spp d8, statistical)",
          res["ok"], res)
    for mode in ("exact", "fast"):
        res = v.backend_check("grid", "bruteforce", mode=mode)
        check(f"grid kernel vs bruteforce {mode} (128x72 2spp d8, <=1% "
              "pixels differ: Triton and XLA round FMAs differently)",
              res["ok"], res)
    res = v.backend_check("auto", "bruteforce",
                          scene=random_sphere_field(100_000, seed=1),
                          size=(96, 56), bad_frac=0.02)
    check("100k field: auto route vs chunked bruteforce (96x56 2spp d8, "
          "<=2% pixels differ)", res["ok"], res)
    res = v.bandsplit_check("grid")
    check("grid band split vs whole frame (bitwise)", res["ok"], res)
    res = v.fast_check(backend="grid")
    check("fast vs exact mode (64 spp, statistical)", res["ok"], res)


def served_loop() -> None:
    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.runtime.viewer import LiveViewer
    from raytrace_tpu.utils.png import decode_png

    spp = 64
    viewer = LiveViewer(RenderConfig(samples=spp, width=WIDTH, height=HEIGHT,
                                     samples_per_call=2), port=0)
    port = viewer.start_server()
    render = threading.Thread(target=viewer.render_loop,
                              kwargs=dict(max_frames=1), daemon=True)
    render.start()
    frames = []  # (samples_done, png bytes) of distinct refinements

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.read()

    def fetch():
        # a frame counts when /state reads the same sample count before and
        # after it, and that count is past the last one kept
        deadline = time.monotonic() + 300
        while len(frames) < 3 and time.monotonic() < deadline:
            before = json.loads(get("/state"))["samples_done"]
            try:
                png = get("/frame.png")
            except urllib.error.HTTPError as e:  # 503 until the first frame
                if e.code != 503:
                    raise
                time.sleep(0.05)
                continue
            after = json.loads(get("/state"))["samples_done"]
            if before == after and (not frames or after > frames[-1][0]):
                frames.append((after, png))
            time.sleep(0.05)

    client = threading.Thread(target=fetch)
    client.start()
    client.join()
    render.join(timeout=300)
    final = json.loads(get("/state"))["samples_done"]
    viewer.stop()
    imgs = [decode_png(png) for _, png in frames]
    counts = [n for n, _ in frames]
    check(f"served loop: 3 progressive refinements over HTTP at "
          f"{WIDTH}x{HEIGHT}",
          len(frames) == 3 and counts == sorted(set(counts))
          and len({png for _, png in frames}) == 3
          and all(f.shape == (HEIGHT, WIDTH, 3) for f in imgs)
          and final == spp and not render.is_alive(),
          f"port {port}, samples_done at each fetch {counts} (of {spp}, "
          f"final {final}), frames {[f.shape for f in imgs]}, means "
          f"{[round(float(f.mean()), 2) for f in imgs]}")


def gpu_tests() -> None:
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome == "skipped":
                self.outcomes[report.outcome] = (
                    self.outcomes.get(report.outcome, 0) + 1)

    os.environ["RAYTRACE_TEST_DEVICE"] = "gpu"
    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests", "test_gpu.py")],
                     plugins=[counter])
    check("tests marked gpu", int(rc) == 0
          and counter.outcomes.get("passed", 0) > 0
          and not counter.outcomes.get("skipped"), counter.outcomes)


# ---- four cards ---------------------------------------------------------------

def four_cards() -> None:
    import jax

    from raytrace_tpu.config import RenderConfig
    from raytrace_tpu.models.scene import generate_random_scene
    from raytrace_tpu.ops.trace import render_band
    from raytrace_tpu.parallel import hetero
    from raytrace_tpu.parallel.hetero import HeteroRenderer
    from raytrace_tpu.parallel.sharding import MultiChipRenderer
    from raytrace_tpu.runtime.renderer import Renderer

    scene = generate_random_scene(0.0)
    cfg = RenderConfig(samples=8, width=WIDTH, height=HEIGHT, chips=4)
    multi = MultiChipRenderer(cfg, scene=scene)
    t0 = time.perf_counter()
    a = np.asarray(multi.render(8)[0])
    log(f"4 cards ({multi.backend}, M={multi.pixels_per_lane}): "
        f"{time.perf_counter() - t0:.2f}s incl. compile")
    one = Renderer(cfg, scene=scene)
    b = np.asarray(one.render(8)[0])
    diff = np.abs(a - b).max(axis=2)
    check("4-card row bands == 1-card frame (bitwise, global seeds)",
          np.array_equal(a, b) and np.isfinite(a).all(),
          f"{int((diff > 0).sum())} of {diff.size} pixels differ, max "
          f"{float(diff.max())}")
    # record where each band's output lands: HeteroRenderer hands band i to
    # device i and fetches it to the host itself
    devs = []

    def render_band_on(*args, **kw):
        out = render_band(*args, **kw)
        devs.append(str(next(iter(out.devices()))))
        return out

    h = HeteroRenderer(dataclasses.replace(cfg, samples=2), scene=scene,
                       reference_banding=False)
    hetero.render_band = render_band_on
    try:
        _, dpf, _ = h.tune_round(2, frames=1)
    finally:
        hetero.render_band = render_band
    check("hetero tune_round: each band on its own card",
          len(set(devs)) == 4 and set(devs) == {str(d) for d in jax.devices()},
          f"bands {h.rows} on {devs}, {dpf:.3f}s/frame")


def main() -> int:
    four = "--four" in sys.argv[1:]
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    import raytrace_tpu  # noqa: F401  (the package must import)

    log(card_line())
    log(f"jax {jax.__version__}: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}")
    if four:
        if len(jax.devices()) < 4:
            print("--four needs 4 GPUs", file=sys.stderr)
            return 2
        phase(four_cards)
    else:
        for fn in (main_path, comparisons, served_loop, gpu_tests):
            phase(fn)
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    if FAILURES:
        print(f"chip_smoke.py: failed: {', '.join(FAILURES)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
