"""A synthetic test sequence and its CLI config, for driving the port's GOP
path (`python -m lssvc_tpu_torch.test`) without a real dataset.

The sequence is 8-bit YUV 4:2:0: a smooth texture (cubic-upsampled
noise, one noise sample per `grain` luma pixels) that moves by `step`
luma pixels a frame, so the motion search sees motion.  Drawn from a
numpy seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy import ndimage


def _smooth_plane(rng, h, w, grain):
    noise = rng.random((h // grain + 2, w // grain + 2))
    return ndimage.zoom(noise, grain, order=3)[:h, :w]


def write_sequence(path, h, w, frames, seed, step=(2, 4), grain=8):
    """Write `frames` frames of h x w (both even) to `path`."""
    rng = np.random.default_rng(seed)
    dy, dx = step
    big_h, big_w = h + dy * frames + 2, w + dx * frames + 2
    luma = _smooth_plane(rng, big_h, big_w, grain)
    chroma = [_smooth_plane(rng, big_h // 2, big_w // 2, max(grain // 2, 1))
              for _ in range(2)]

    def crop(plane, oy, ox, ph, pw):
        return np.clip(plane[oy:oy + ph, ox:ox + pw] * 255 + 0.5, 0, 255) \
            .astype(np.uint8).tobytes()

    with open(path, "wb") as f:
        for t in range(frames):
            f.write(crop(luma, t * dy, t * dx, h, w))
            for plane in chroma:
                f.write(crop(plane, t * dy // 2, t * dx // 2, h // 2, w // 2))


def write_dataset(root, h, w, frames, gop, seed, ds_name="synthetic",
                  seq="seq1") -> Path:
    """A one-sequence dataset under `root` in the CLI's config schema;
    returns the config file's path."""
    root = Path(root)
    (root / seq).mkdir(parents=True, exist_ok=True)
    write_sequence(root / seq / "x1.yuv", h, w, frames, seed)
    cfg = root / "config.json"
    cfg.write_text(json.dumps({ds_name: {
        "test": 1, "base_path": str(root), "x1": {"width": w, "height": h},
        "x2": {"width": w // 2, "height": h // 2},
        "sequences": {seq: {"frames": frames, "gop": gop}}}}, indent=2))
    return cfg
