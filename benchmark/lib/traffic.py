"""The one traffic generator: a mix's parameters (a JSON file under
`benchmark/traffic/`) and a run's seed -> the two-layer frames a cell codes.

The picture is the program's `synthetic_motion_frames` (the bench twin,
`lssvc_tpu_torch/bench.py`, commit 4d8626f): a smooth texture (uniform
noise on a grid of `texture_cell`-pixel cells, bilinearly interpolated)
panned by `pan_px_per_frame` pixels a frame along both axes, with a
square of one random colour, an eighth of the height on a side, moving
by `square_px_per_frame` (down, across) pixels a frame.  Here it is drawn
on the device from a `torch.Generator` seeded with the run's seed, and
then taken through what a user's file holds, as the reference's test
harness reads one: RGB -> BT.709 full-range YCbCr, chroma averaged over
2x2, each plane rounded to `bit_depth` bits, back to RGB with the chroma
bilinearly upsampled (`lssvc_tpu_torch/utils/color.py`).  The EL input is
that RGB frame zero-padded at the bottom and right to the padded EL size;
the BL input is the padded EL frame resized to the padded BL size by
MATLAB's antialiased bicubic (`utils/resize.py`, copied in `resize.py`)
and clamped to [0, 1], as `harness/runner.py` `layer_inputs` makes them.

Every seed gives the same sizes and the same motion; the seed changes the
texture and the square's colours.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import imresize

BT709 = (0.2126, 0.7152, 0.0722)


def interlayer_padding(height: int, width: int, ratio: float) -> dict:
    """The padded EL and BL sizes (the reference's `common.py:48-86`, the
    program's `utils/padding.py` `get_interlayer_padding`): the smallest
    EL size divisible by 64 and by 64 * ratio, the BL that divided by
    ratio."""

    def padded(n):
        i = 0
        while True:
            p = 64 + 32 * i
            m = (n + p - 1) // p * p
            if m % 64 == 0 and m % (64 * ratio) == 0:
                return m
            i += 1

    h_el, w_el = padded(height), padded(width)
    return {"el": (h_el, w_el), "bl": (int(h_el / ratio), int(w_el / ratio))}


def _texture(h, w, cell, gen, device):
    small = torch.rand((3, h // cell + 2, w // cell + 2), generator=gen,
                       device=device)
    # scipy.ndimage.zoom(order=1) by `cell`: linear between cell corners
    big = F.interpolate(small[None], size=((h // cell + 2) * cell,
                                           (w // cell + 2) * cell),
                        mode="bilinear", align_corners=True)[0]
    return big[:, :h, :w]


def _ycbcr_roundtrip(rgb, bits):
    """3xHxW RGB -> 4:2:0 YCbCr at `bits` bits -> RGB, clamped."""
    kr, kg, kb = BT709
    r, g, b = rgb[0:1], rgb[1:2], rgb[2:3]
    y = kr * r + kg * g + kb * b
    cb = 0.5 * (b - y) / (1 - kb) + 0.5
    cr = 0.5 * (r - y) / (1 - kr) + 0.5
    uv = F.avg_pool2d(torch.cat([cb, cr])[None], 2)[0]
    levels = float((1 << bits) - 1)
    y = torch.round(y.clamp(0, 1) * levels) / levels
    uv = torch.round(uv.clamp(0, 1) * levels) / levels
    uv = F.interpolate(uv[None], scale_factor=2, mode="bilinear",
                       align_corners=False)[0]
    cb, cr = uv[0:1], uv[1:2]
    r = y + (2 - 2 * kr) * (cr - 0.5)
    b = y + (2 - 2 * kb) * (cb - 0.5)
    g = (y - kr * r - kb * b) / kg
    return torch.cat([r, g, b]).clamp(0, 1)


def make_frames(mix: dict, config: dict, seed: int, device):
    """The mix's `frames` two-layer frames: ([x_bl], [x_el]), each
    (1, H, W, 3) float32 NHWC, padded; in pinned host memory when `device`
    is a card (a user's frames come from the host), else on `device`."""
    if mix["generator"] != "synthetic_motion":
        raise ValueError(f"generator {mix['generator']!r}")
    h, w = config["height"], config["width"]
    pad = interlayer_padding(h, w, config["ratio"])
    (he, we), (hb, wb) = pad["el"], pad["bl"]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    cell = int(mix["texture_cell"])
    base = _texture(h, w, cell, gen, device)
    colours = torch.rand((mix["frames"], 3), generator=gen, device=device)
    sq = h // 8
    pan = float(mix["pan_px_per_frame"])
    dy, dx = mix["square_px_per_frame"]
    on_card = device.type == "cuda"
    frames_bl, frames_el = [], []
    for t in range(mix["frames"]):
        s = int(pan * t)
        f = torch.roll(base, (s % h, s % w), dims=(1, 2)).clone()
        y0 = (h // 4 + dy * t) % (h - sq)
        x0 = (w // 4 + dx * t) % (w - sq)
        f[:, y0:y0 + sq, x0:x0 + sq] = colours[t][:, None, None]
        rgb = _ycbcr_roundtrip(f, int(mix["bit_depth"]))
        x_el = F.pad(rgb[None], (0, we - w, 0, he - h))
        x_bl = imresize(x_el, sizes=(hb, wb)).clamp(0, 1)
        x_el = x_el.permute(0, 2, 3, 1).contiguous()
        x_bl = x_bl.permute(0, 2, 3, 1).contiguous()
        if on_card:
            x_el, x_bl = (x.to("cpu").pin_memory() for x in (x_el, x_bl))
        frames_bl.append(x_bl)
        frames_el.append(x_el)
    return frames_bl, frames_el


def gop_frames(mix: dict, t0: int, n: int) -> list[int]:
    """Indices into the held frames of the `n` frames from the `t0`-th of
    the sequence, cycling through the held frames."""
    held = mix["frames"]
    return [(t0 + k) % held for k in range(n)]
