"""A PNG codec on the standard library (`zlib`, `struct`) and numpy.

Reads 8-bit greyscale, grey + alpha, RGB and RGBA images, and palette and
greyscale images of 1, 2, 4 or 8 bits, non-interlaced, with all five
scanline filters; writes 8-bit RGB. Every PNG the port reads or writes
goes through it, so reading a scene's frames and writing renders needs no
imaging package. Filters 0-2 (what `write_png` and most encoders emit for
renders) decode as numpy array operations; the average and Paeth filters
run a Python loop over the row's bytes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel: grey, RGB, palette, grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def is_png(path: str) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> (height, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"image data holds {rows.size} bytes, want {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # sub: a running sum over the bytes bpp apart
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def convert(px: np.ndarray, mode: str | None) -> np.ndarray:
    """Samples (H, W, C) -> `mode` as Pillow's `convert` gives it: "RGB"
    drops alpha, "RGBA" adds an opaque one, grey is repeated."""
    if mode is None:
        return px
    c = px.shape[-1]
    rgb = px[..., :3] if c >= 3 else np.repeat(px[..., :1], 3, axis=-1)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if mode == "RGBA":
        alpha = px[..., -1:] if c in (2, 4) else np.full(px.shape[:2] + (1,), 255, np.uint8)
        return np.concatenate([rgb, alpha], axis=-1)
    raise ValueError(f"unknown mode {mode!r}")


def read_png(path: str, mode: str | None = None) -> np.ndarray:
    """Decode a PNG file -> (H, W, C) uint8. With `mode` None, C is the
    file's own: 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA, and a palette image
    expands to RGB, or to RGBA when it has a transparency chunk (a
    transparency chunk of a grey or RGB image is ignored, as Pillow's
    conversions ignore it). `mode` "RGB" or "RGBA" converts as Pillow's
    `Image.convert` does. Raises ValueError on a file it cannot decode."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, max(channels * depth // 8, 1))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(-1, dtype=np.uint8)
        if ctype == 0:  # scale grey to 8 bits
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    px = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        px = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns[: len(palette)]
            px = np.concatenate([px, alpha[idx][..., None]], axis=-1)
    return convert(px, mode)


def write_png(path: str, image: np.ndarray) -> None:
    """Encode an (H, W, 3) uint8 image as an 8-bit RGB PNG (no filter,
    zlib level 6)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def to_uint8(image) -> np.ndarray:
    """A float image in [0, 1] (numpy or tensor) -> uint8, clipped and
    truncated as the JAX package writes its PNGs."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    return (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
