"""A PNG reader and writer in numpy and ``zlib``, for machines without cv2 or PIL.

``read_png`` (a file) and ``decode_png`` (bytes) decode 8-bit,
non-interlaced gray, gray+alpha, RGB and RGBA PNGs (all five row filters) to
RGB uint8, dropping alpha as cv2's ``IMREAD_COLOR`` and PIL's
``convert("RGB")`` do; they raise ValueError for any other format.
``write_png`` writes RGB uint8 with the filter-free rows it reads fastest.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed stream -> (h, w*bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data.copy()
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(kinds[y]), data[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum of the pixel to the left, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            cur_b = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_b[i] = (cur_b[i] + pred) & 255
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG file to (H, W, 3) RGB uint8."""
    return decode_png(Path(path).read_bytes(), str(path))


def decode_png(data: bytes, path: str = "PNG bytes") -> np.ndarray:
    """Decode PNG bytes to (H, W, 3) RGB uint8; ``path`` names them in errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file; decoding other formats needs cv2 or PIL")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}; this reader takes 8-bit non-interlaced gray/RGB/RGBA "
            "(decoding others needs cv2 or PIL)")
    bpp = CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray, level: int = 1) -> None:
    """Write (H, W, 3) RGB uint8 as an 8-bit PNG, every row unfiltered."""
    h, w, c = image.shape
    if c != 3 or image.dtype != np.uint8:
        raise ValueError(f"write_png: (H, W, 3) uint8, got {image.shape} {image.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
