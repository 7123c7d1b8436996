"""Bitstream container format (a copy of the JAX package's `utils/stream.py`).

The byte layout is the reference's (`src/utils/stream_helper.py:61-99`):

  I-frame file: big-endian u32 [height, width, len(y_string), len(z_string)]
                followed by y_string then z_string.
  P-frame file: big-endian u32 [len(string)] followed by string.
"""

from __future__ import annotations

import struct
from pathlib import Path


def get_downsampled_shape(height: int, width: int, p: int,
                          resample_times: int = 1):
    pad_d = p * resample_times
    new_h = (height + pad_d - 1) // pad_d * pad_d
    new_w = (width + pad_d - 1) // pad_d * pad_d
    return int(new_h / p + 0.5), int(new_w / p + 0.5)


def filesize(filepath) -> int:
    if not Path(filepath).is_file():
        raise ValueError(f'Invalid file "{filepath}".')
    return Path(filepath).stat().st_size


def encode_i(height: int, width: int, y_string: bytes, z_string: bytes,
             output):
    with Path(output).open("wb") as f:
        f.write(struct.pack(">4I", height, width, len(y_string),
                            len(z_string)))
        f.write(y_string)
        f.write(z_string)


def decode_i(inputpath):
    with Path(inputpath).open("rb") as f:
        height, width, y_len, z_len = struct.unpack(">4I", f.read(16))
        y_string = f.read(y_len)
        z_string = f.read(z_len)
    if len(y_string) != y_len or len(z_string) != z_len:
        raise ValueError(f"{inputpath}: truncated I-frame stream")
    return height, width, y_string, z_string


def encode_p(string: bytes, output):
    with Path(output).open("wb") as f:
        f.write(struct.pack(">I", len(string)))
        f.write(string)


def decode_p(inputpath) -> bytes:
    with Path(inputpath).open("rb") as f:
        (length,) = struct.unpack(">I", f.read(4))
        string = f.read(length)
    if len(string) != length:
        raise ValueError(f"{inputpath}: truncated P-frame stream")
    return string
