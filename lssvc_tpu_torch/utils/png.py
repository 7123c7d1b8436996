"""A minimal 8-bit PNG writer and reader over `zlib` (the artifact dumps'
format; the JAX package writes them through PIL, which is not a declared
dependency of the repo, so the port keeps to the standard library).

`write_png` writes one IHDR (8-bit, grey or RGB, no interlace), one IDAT
(the rows, each after filter byte 0, deflated) and IEND, each chunk with
its CRC-32.  `read_png` reads back what `write_png` writes (and any other
8-bit grey or RGB PNG whose rows all use filter 0), checking every CRC.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_COLOUR = {0: 1, 2: 3}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> the bytes of a PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {img.dtype}")
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path) -> np.ndarray:
    """The pixels of an 8-bit grey or RGB, non-interlaced PNG whose rows
    use filter 0: (H, W) or (H, W, 3) uint8.  Raises ValueError on a bad
    signature, CRC, header or filter byte."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _COLOUR or interlace:
        raise ValueError(f"{path}: unsupported header {header}")
    channels = _COLOUR[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    pixels = rows[:, 1:].reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels
