"""Compare our renderer against the reference's shipped sceneRender.png.

VERDICT r1 item 5: tie the framework to the actual Vulkan renderer's pixels,
not just our own oracle.  The honest outcome, documented in docs/PARITY.md:

``/root/reference/sceneRender.png`` does NOT depict what the reference's
*current code* renders.  Evidence:
 - the image shows a near-ground camera (horizon visible, heroes seen from
   the side) — the code pins the camera at (13,11,-3) looking at the origin
   from above (ray_trace.cpp:669-670), which yields a top-down view;
 - README.md:3 hotlinks the image from the TwentyFiveSoftware *upstream*
   repo, i.e. it predates this fork entirely;
 - the upstream image's hero line-up / checker scale match the upstream
   project's parameters (book camera ~(13,2,3), fov 20), not this fork's
   baked fov 25 at (13,11,-3).

A pixel diff against it therefore fails for any faithful implementation of
/root/reference's code — including the reference itself as currently built.
This script records the comparison anyway at two parameterizations and
writes tile statistics so the judgment is reproducible:
 1. the reference code's own camera (13,11,-3) — our ground truth claim;
 2. the closest approximation of the image's vintage camera (13,2,3).

Usage: python scripts/compare_reference_png.py [spp] (GPU recommended)
"""
import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from raytrace_tpu.config import RenderConfig
from raytrace_tpu.runtime.renderer import Renderer
from raytrace_tpu.utils.compare import compare_accums

REF_PNG = "/root/reference/sceneRender.png"


def read_png_rgb(path):
    """Minimal PNG reader (8-bit RGB/RGBA, non-interlaced)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h, ctype = 8, b"", 0, 0, 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        typ = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if typ == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype in (2, 6)
        elif typ == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    ch = 3 if ctype == 2 else 4
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    p = 0
    for y in range(h):
        f = raw[p]
        row = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).copy()
        p += 1 + stride
        if f == 0:
            pass
        elif f == 1:
            for i in range(ch, stride):
                row[i] = (int(row[i]) + int(row[i - ch])) & 0xFF
        elif f == 2:
            row[:] = (row.astype(np.int32) + prev) & 0xFF
        elif f == 3:
            for i in range(stride):
                a = int(row[i - ch]) if i >= ch else 0
                row[i] = (int(row[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
        elif f == 4:
            for i in range(stride):
                a = int(row[i - ch]) if i >= ch else 0
                b = int(prev[i])
                c = int(prev[i - ch]) if i >= ch else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (int(row[i]) + pred) & 0xFF
        out[y] = row
        prev = out[y]
    img = out.reshape(h, w, ch)[:, :, :3]
    return img


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    ref = read_png_rgb(REF_PNG).astype(np.float64) / 255.0
    h, w = ref.shape[:2]
    print(f"reference image: {w}x{h}", flush=True)
    # linearize the reference u8 (gamma-2 display encoding, shader.rgen:65)
    ref_lin = ref * ref

    results = {}
    for name, campos in (("reference-code camera (13,11,-3)", None),
                         ("vintage/book camera (13,2,3)", (13.0, 2.0, 3.0))):
        cfg = RenderConfig(samples=spp, width=w, height=h,
                           camera_pos=campos,
                           camera_dir=None if campos is None else
                           tuple(-c for c in campos))
        r = Renderer(cfg)
        accum, total = r.render(spp)
        ours_lin = np.asarray(accum, np.float64) / total
        res = compare_accums(ours_lin * spp, ref_lin * spp, spp, spp)
        results[name] = res
        print(f"[{name}] {res}", flush=True)
    return results


if __name__ == "__main__":
    main()
