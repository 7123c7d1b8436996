"""BT.709 colour conversion and 4:2:0 <-> 4:4:4 chroma resampling on the
host (a copy of the JAX package's `utils/color.py`, numpy and scipy only).

Numerics match the reference (`src/utils/functional.py`): RGB<->YCbCr with
the ITU-R BT.709 coefficients; 444->420 is a 2x2 mean; 420->444 upsampling
is a spline of the requested order (1 = bilinear through
scipy.ndimage.zoom, the reference's choice).  The conventions (BT.709
full-range equations, 2x2 mean subsampling, clip placement) follow the
DCVC colour utilities (Microsoft, MIT license, vendored by the reference):
result JSONs are comparable only if the YUV<->RGB round trip is the same.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

YCBCR_WEIGHTS = {
    # (K_r, K_g, K_b) with K_g = 1 - K_r - K_b
    "ITU-R_BT.709": (0.2126, 0.7152, 0.0722),
}


def _to_ycbcr_planes(r, g, b):
    """BT.709 full-range forward equations on separate planes."""
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    y = Kr * r + Kg * g + Kb * b
    cb = 0.5 * (b - y) / (1 - Kb) + 0.5
    cr = 0.5 * (r - y) / (1 - Kr) + 0.5
    return y, cb, cr


def _to_rgb_planes(y, cb, cr):
    """Inverse of `_to_ycbcr_planes` (exact algebraic inverse: G is
    recovered from the luma equation, not an independent matrix row)."""
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    r = y + (2 - 2 * Kr) * (cr - 0.5)
    b = y + (2 - 2 * Kb) * (cb - 0.5)
    g = (y - Kr * r - Kb * b) / Kg
    return r, g, b


def _mean_2x2(plane: np.ndarray) -> np.ndarray:
    """1xHxW -> 1x(H/2)x(W/2) by 2x2 arithmetic mean (420 subsampling)."""
    _, h, w = plane.shape
    return plane.reshape(1, h // 2, 2, w // 2, 2).mean(axis=(-1, -3))


def rgb_to_ycbcr420(rgb: np.ndarray):
    """3xHxW RGB float [0,1] -> (y: 1xHxW, uv: 2x(H/2)x(W/2))."""
    c, h, w = rgb.shape
    assert c == 3
    assert h % 2 == 0 and w % 2 == 0
    y, cb, cr = _to_ycbcr_planes(*np.split(rgb, 3, axis=0))
    # subsample chroma BEFORE clipping (the mean of out-of-gamut values
    # differs from the mean of clipped ones; reference clip placement)
    uv = np.concatenate((_mean_2x2(cb), _mean_2x2(cr)), axis=0)
    return np.clip(y, 0.0, 1.0), np.clip(uv, 0.0, 1.0)


def ycbcr420_to_rgb(y: np.ndarray, uv: np.ndarray, order: int = 1) -> np.ndarray:
    """(y: 1xHxW, uv: 2x(H/2)x(W/2)) float [0,1] -> 3xHxW RGB float [0,1].

    order: 0 nearest neighbour, 1 bilinear (default).
    """
    uv = scipy.ndimage.zoom(uv, (1, 2, 2), order=order)
    r, g, b = _to_rgb_planes(y, uv[0:1], uv[1:2])
    return np.clip(np.concatenate((r, g, b), axis=0), 0.0, 1.0)

