"""Raw 8-bit YUV 4:2:0 planar reader and writer (the JAX package's
`utils/io.py` `YUVReader` and `YUVWriter`; numpy only).

The reference's file format (`src/utils/video_reader.py`): one frame is a
W x H Y plane, then the U and V planes at half width and height, values
normalised to [0, 1] float32.
"""

from __future__ import annotations

import numpy as np

from .color import rgb_to_ycbcr420


class YUVReader:
    def __init__(self, src_path, width, height, skip_frame=0):
        """`skip_frame`: start at that frame (the JAX package's reader
        skips by reading; a seek past the end reads nothing)."""
        self.width = width
        self.height = height
        self.eof = False
        self.y_size = width * height
        self.uv_size = width * height // 2
        self.file = open(src_path, "rb")
        self.file.seek(skip_frame * (self.y_size + self.uv_size))

    def read_one_frame(self):
        """(y 1xHxW, uv 2x(H/2)x(W/2)); (None, None) past the last complete
        frame."""
        if not self.eof:
            y = self.file.read(self.y_size)
            uv = self.file.read(self.uv_size)
            # a truncated last frame ends the sequence
            self.eof = len(y) < self.y_size or len(uv) < self.uv_size
        if self.eof:
            return None, None
        y = np.frombuffer(y, dtype=np.uint8).reshape(
            1, self.height, self.width).astype(np.float32) / 255
        uv = np.frombuffer(uv, dtype=np.uint8).reshape(
            2, self.height // 2, self.width // 2).astype(np.float32) / 255
        return y, uv

    def close(self):
        self.file.close()


def yuv420_bytes(rgb: np.ndarray) -> bytes:
    """A 3xHxW RGB frame in [0, 1] as one 8-bit 4:2:0 frame: converted to
    YCbCr 4:2:0, then rint(x * 255) clipped to [0, 255] (the JAX package's
    `YUVWriter.write_one_frame(rgb=...)`)."""
    y, uv = rgb_to_ycbcr420(rgb)
    return b"".join(np.clip(np.rint(p * 255), 0, 255).astype(np.uint8)
                    .tobytes() for p in (y, uv))


class YUVWriter:
    """Writes 8-bit 4:2:0 frames, each a W x H Y plane then the U and V
    planes at half width and height (`decode.yuv_frame` and `yuv420_bytes`
    make them)."""

    def __init__(self, dst_path, width, height):
        self.frame_size = width * height * 3 // 2
        self.file = open(dst_path, "wb")

    def write_one_frame(self, frame: bytes):
        if len(frame) != self.frame_size:
            raise ValueError(f"a frame of {len(frame)} bytes, expected "
                             f"{self.frame_size}")
        self.file.write(frame)

    def close(self):
        self.file.close()
