"""PNG writer roundtrip (utils/png.py), decoded independently with PIL and
by the package's own reader."""

import numpy as np
import pytest

from raytrace_tpu.utils.png import decode_png, encode_png, write_png


def test_roundtrip(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = tmp_path / "t.png"
    write_png(str(p), img)
    back = np.asarray(PIL.open(p).convert("RGB"))
    assert np.array_equal(back, img)


def test_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))


def test_decode_roundtrip():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)


def test_decode_rejects_corruption():
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError):
        decode_png(b"GIF89a" + bytes(data[6:]))
    data[-20] ^= 0xFF  # inside the IDAT payload: CRC mismatch
    with pytest.raises(ValueError):
        decode_png(bytes(data))
