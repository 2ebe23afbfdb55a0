"""Minimal dependency-free PNG writer and reader (RGB8).

The reference parses ``--store`` but never writes an image — stb is wired into
its build yet unused (SURVEY.md quirk Q2, /root/reference/CMakeLists.txt:66-75).
This delivers the capability the flag promises.  Pure zlib + struct; no PIL
dependency in the framework itself (tests cross-check with PIL).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as RGB PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes written by ``encode_png`` (8-bit RGB, one IDAT
    stream, filter 0 on every scanline) to an [H, W, 3] uint8 array;
    raises ValueError on anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, ihdr, idat = 8, None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if ihdr is None or ihdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {ihdr}")
    w, h = ihdr[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (raw[:, 0] != 0).any():
        raise ValueError("unsupported scanline filter")
    return raw[:, 1:].reshape(h, w, 3).copy()
