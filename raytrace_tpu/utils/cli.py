"""CLI — mirror of the reference argument surface (main.cpp:10-64).

Same six flags with the same defaults (--help/--store/--samples/--width/
--height/--gpus), the same "unknown argument" stderr behavior, plus extras
that have no Vulkan analogue (--out/--backend/--depth/--time/
--samples-per-call/...).  Unlike the reference, --store actually writes a PNG
(quirk Q2 delivered).
"""

from __future__ import annotations

import sys

HELP = """\
--help                            # Show this help infomation
--store                           # Store rendered image to file
--samples <count>                 # Total samples to render
--width <width>                   # Image width
--height <height>                 # Image height
--gpus <count>                    # Max used devices count
--out <path>                      # Output PNG path (default render.png)
--backend <auto|grid|matmul|bruteforce>  # Intersection backend
--depth <count>                   # Max bounce depth (default 50)
--time <seconds>                  # Scene animation time (default 0)
--samples-per-call <count>        # Progressive accumulation chunk
--accum <float32|float64>         # Cross-call accumulator dtype (Q5 dvec3)
--mode <exact|fast>               # fast = Russian-roulette production mode
--preview                         # Write the running PNG after each call
--frames <count>                  # Animated frame loop (0 = adaptive window)
--checkpoint <path>               # Resume/checkpoint progressive renders
--serve <port>                    # Live progressive HTTP viewer (0 = auto);
                                  # with --gpus N>1 and/or --frames: the
                                  # animated multi-device production loop
                                  # (scene animation + per-device bands +
                                  # live tuner re-splits in one process)
"""


BACKENDS = ("auto", "grid", "matmul", "bruteforce")


class CLIError(Exception):
    """Bad command line — reported as one readable stderr line (the
    reference's graceful unknown-arg handling, main.cpp:49, extended to
    missing/invalid values)."""


def parse_args(argv):
    """Hand-rolled argv loop like main.cpp:19-51. Returns kwargs for
    api.ray_trace, or None if --help was printed.  Raises CLIError on a
    missing/malformed flag value or unknown --backend."""
    kw = dict(samples=10, store_render_result=False, width=1920, height=1080,
              gpu_count=1)
    extras = {}
    i = 0
    while i < len(argv):
        a = argv[i]

        def _take():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise CLIError(f"missing value for {a}")
            return argv[i]

        def _take_num(conv=int):
            v = _take()
            try:
                return conv(v)
            except ValueError:
                raise CLIError(f"invalid value for {a}: {v!r}") from None

        if a == "--help":
            print(HELP, end="")
            return None
        elif a == "--store":
            kw["store_render_result"] = True
        elif a == "--samples":
            kw["samples"] = _take_num()
        elif a == "--width":
            kw["width"] = _take_num()
        elif a == "--height":
            kw["height"] = _take_num()
        elif a == "--gpus":
            kw["gpu_count"] = _take_num()
        elif a == "--out":
            extras["out_path"] = _take()
        elif a == "--backend":
            b = _take()
            if b not in BACKENDS:
                raise CLIError(
                    f"unknown backend: {b!r} (expected one of "
                    f"{'|'.join(BACKENDS)})")
            extras["backend"] = b
        elif a == "--depth":
            extras["max_depth"] = _take_num()
        elif a == "--time":
            extras["scene_time"] = _take_num(float)
        elif a == "--samples-per-call":
            extras["samples_per_call"] = _take_num()
        elif a == "--accum":
            extras["accum_dtype"] = _take()
        elif a == "--mode":
            m = _take()
            if m not in ("exact", "fast"):
                raise CLIError(f"unknown mode: {m!r} (expected exact|fast)")
            extras["mode"] = m
        elif a == "--preview":
            extras["preview"] = True
        elif a == "--frames":
            extras["_frames"] = _take_num()
        elif a == "--checkpoint":
            extras["_checkpoint"] = _take()
        elif a == "--serve":
            extras["_serve"] = _take_num()
        else:
            print(f"unknown argument: {a}", file=sys.stderr)
        i += 1
    kw.update(extras)
    return kw


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    try:
        kw = parse_args(argv)
    except CLIError as e:
        print(e, file=sys.stderr)
        return 1
    if kw is None:
        return 0
    frames = kw.pop("_frames", None)
    checkpoint = kw.pop("_checkpoint", None)
    serve = kw.pop("_serve", None)
    try:
        if serve is not None:
            # live progressive viewer + camera input (C8: the headless
            # analogue of the reference's per-GPU windows, window.hpp:29-54)
            from ..config import RenderConfig

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                chips=kw["gpu_count"],
                max_depth=kw.get("max_depth", 50),
                backend=kw.get("backend", "auto"),
                samples_per_call=kw.get("samples_per_call"),
                mode=kw.get("mode", "exact"),
                scene_time=kw.get("scene_time", 0.0),
            )
            if kw["gpu_count"] > 1 or frames is not None:
                # the reference's actual operating mode: animated scene +
                # per-device bands + live tuner re-splits in ONE loop
                # (ray_trace.cpp:579-776), served over HTTP
                from ..runtime.production import ProductionLoop

                ProductionLoop(cfg, port=serve).run(
                    max_frames=frames if frames else None)
            else:
                from ..runtime.viewer import LiveViewer

                LiveViewer(cfg, port=serve).run()
        elif checkpoint is not None:
            from ..config import RenderConfig
            from ..ops.image import accum_to_u8
            from ..runtime.renderer import Renderer

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                max_depth=kw.get("max_depth", 50), backend=kw.get("backend", "auto"),
                samples_per_call=kw.get("samples_per_call"),
                scene_time=kw.get("scene_time", 0.0),
            )
            r = Renderer(cfg)
            every = cfg.samples_per_call or max(1, cfg.samples // 20)
            accum, done = r.render_resumable(
                cfg.samples, checkpoint_path=checkpoint, checkpoint_every=every)
            if kw["store_render_result"]:
                from ..utils.png import write_png
                import numpy as np

                write_png(kw.get("out_path", "render.png"),
                          np.asarray(accum_to_u8(accum, done)))
        elif frames is not None:
            # animated frame loop (reference frame-loop mode, quirk Q8)
            from ..config import RenderConfig
            from ..runtime.frames import FrameLoop

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                chips=kw["gpu_count"],
                max_depth=kw.get("max_depth", 50),
                backend=kw.get("backend", "auto"),
            )
            pattern = None
            if kw["store_render_result"]:
                out = kw.get("out_path", "render.png")
                pattern = out.replace(".png", "_{0}.png") if "{0}" not in out else out
            FrameLoop(cfg).run(frames=frames, store_pattern=pattern)
        else:
            from ..api import ray_trace

            ray_trace(**kw)
    except Exception as e:  # main.cpp:61-63: catch, print, exit cleanly
        print(e, file=sys.stderr)
        return 1
    return 0
