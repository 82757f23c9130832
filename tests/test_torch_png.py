"""`gsattack_torch/io/png.py` against Pillow: every colour type the port
reads, each of the five scanline filters, the writer, and the image
loaders of `io/dataset.py` against the JAX package's with and without
Pillow."""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from gsattack.io import dataset as jds
from gsattack_torch.io import dataset as tds
from gsattack_torch.io import png

RNG = np.random.default_rng(5)


def _pillow_images(tmp_path):
    """Files written by Pillow: name -> (path, what Pillow decodes)."""
    out = {}

    def save(name, im, **kw):
        path = str(tmp_path / f"{name}.png")
        im.save(path, **kw)
        out[name] = path

    save("rgb", Image.fromarray(RNG.integers(0, 256, (21, 37, 3), dtype=np.uint8)))
    save("rgba", Image.fromarray(RNG.integers(0, 256, (21, 37, 4), dtype=np.uint8), "RGBA"))
    save("l", Image.fromarray(RNG.integers(0, 256, (21, 37), dtype=np.uint8), "L"))
    save("la", Image.fromarray(RNG.integers(0, 256, (21, 37, 2), dtype=np.uint8), "LA"))
    for colours in (2, 16, 200):  # 1-, 4- and 8-bit palettes
        im = Image.fromarray(RNG.integers(0, colours, (21, 37), dtype=np.uint8), "P")
        im.putpalette(RNG.integers(0, 256, 3 * colours, dtype=np.uint8).tolist())
        save(f"p{colours}", im)
        save(f"p{colours}_trns", im, transparency=bytes(RNG.integers(0, 256, colours,
                                                                   dtype=np.uint8)))
    # A smooth image, so that Pillow's adaptive filtering picks more than
    # one filter type.
    yy, xx = np.mgrid[0:40, 0:50]
    smooth = np.stack([xx * 5, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    save("smooth", Image.fromarray(smooth))
    return out


def test_read_png_matches_pillow(tmp_path):
    for name, path in _pillow_images(tmp_path).items():
        with Image.open(path) as im:
            native = np.asarray(im.convert("RGBA" if "trns" in name else "RGB")
                                if im.mode == "P" else im)
            rgb, rgba = np.asarray(im.convert("RGB")), np.asarray(im.convert("RGBA"))
        got = png.read_png(path)
        assert got.dtype == np.uint8 and got.shape[-1] == (native.shape[-1] if native.ndim == 3
                                                            else 1), name
        np.testing.assert_array_equal(got.reshape(native.shape), native, err_msg=name)
        np.testing.assert_array_equal(png.read_png(path, "RGB"), rgb, err_msg=name)
        np.testing.assert_array_equal(png.read_png(path, "RGBA"), rgba, err_msg=name)


def _encode(path, img: np.ndarray, ftype: int) -> None:
    """A PNG of an (H, W, C) uint8 image whose every row uses filter
    `ftype`: the encoder half of the PNG spec's filter arithmetic."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        b = rows[y - 1] if y else np.zeros_like(x)
        cc = np.concatenate([np.zeros(c, np.int64), b[:-c]])
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth][ftype]
        out.append(np.concatenate([[ftype], (x - pred) % 256]).astype(np.uint8))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_type_matches_pillow(tmp_path, ftype):
    for c in (1, 2, 3, 4):
        img = RNG.integers(0, 256, (9, 13, c), dtype=np.uint8)
        path = str(tmp_path / f"f{ftype}_{c}.png")
        _encode(path, img, ftype)
        with Image.open(path) as im:
            want = np.asarray(im).reshape(img.shape)
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(png.read_png(path), img)


def test_write_png_decodes_in_pillow(tmp_path):
    img = RNG.integers(0, 256, (33, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "sub" / "w.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError):
        png.write_png(path, img.astype(np.float32))


def test_bad_files_raise(tmp_path):
    path = tmp_path / "x.png"
    png.write_png(str(path), np.zeros((4, 4, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF  # inside IDAT: the CRC no longer holds
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(path))
    assert tds._load_image(str(path)) is None
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(str(path))


def test_dataset_images_match_jax_without_pillow(tmp_path, monkeypatch):
    """`_load_image` (alpha multiplied) and the Blender frames (RGBA) equal
    the JAX package's Pillow reads, with Pillow blocked for the port; a
    JPEG then raises an ImportError that names it."""
    files = _pillow_images(tmp_path)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(RNG.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(jpg)
    want = {n: jds._load_image(p) for n, p in files.items()}
    want_jpg = jds._load_image(jpg)
    want_rgba = {}
    for n, p in files.items():
        with Image.open(p) as im:
            want_rgba[n] = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(tds._load_image(jpg), want_jpg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for n, p in files.items():
        np.testing.assert_array_equal(tds._load_image(p), want[n], err_msg=n)
        np.testing.assert_array_equal(tds.read_image(p, "RGBA"), want_rgba[n], err_msg=n)
    with pytest.raises(ImportError, match="a.jpg"):
        tds._load_image(jpg)
