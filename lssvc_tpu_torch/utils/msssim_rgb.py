"""RGB MS-SSIM (pytorch_msssim's algorithm) on the host (a copy of the JAX
package's `utils/msssim_rgb.py`, numpy and scipy only).

The reference reports `*_rgb_msssim` through `pytorch_msssim.ms_ssim`
(`test.py:258-259`): per-channel valid-mode Gaussian-window SSIM, 5 levels,
the standard weights, 2x2 average pooling between levels.  The HM-style
per-plane variant is in utils/metrics.py.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve1d

_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def _gaussian_kernel(size: int, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _ssim_cs(x, y, win, data_range, K=(0.01, 0.03)):
    """x, y: (C, H, W). Returns per-CHANNEL (ssim, cs) spatial means —
    pytorch_msssim keeps channels separate until the final cross-level
    product (prod-of-channel-means != mean-of-channel-prods)."""
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2
    pad = len(win) // 2

    def filt(a):
        out = convolve1d(a, win, axis=-1, mode="constant")
        out = convolve1d(out, win, axis=-2, mode="constant")
        return out[..., pad:-pad, pad:-pad]

    mu1 = filt(x)
    mu2 = filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(x * x) - mu1_sq
    sigma2_sq = filt(y * y) - mu2_sq
    sigma12 = filt(x * y) - mu1_mu2
    cs = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    return ssim.mean(axis=(-2, -1)), cs.mean(axis=(-2, -1))  # (C,)


def _avg_pool2(x):
    """F.avg_pool2d(kernel_size=2, padding=s%2) semantics: odd spatial
    dims are ZERO-padded on both sides (count_include_pad) rather than
    truncated — truncation diverges from pytorch_msssim at every odd
    pyramid level (1080 -> 540 -> 270 -> 135 hits one)."""
    c, h, w = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = np.pad(x, ((0, 0), (ph, ph), (pw, pw)))
        h, w = h + 2 * ph, w + 2 * pw
    oh, ow = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    x = x[:, :oh * 2, :ow * 2]
    return x.reshape(c, oh, 2, ow, 2).mean(axis=(2, 4))


def ms_ssim_rgb(img1: np.ndarray, img2: np.ndarray, win_size: int = 11,
                data_range: float = 1.0) -> float:
    """img1/img2: (C, H, W) float arrays."""
    win = _gaussian_kernel(win_size)
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)
    levels = len(_WEIGHTS)
    mcs = []
    ssim_pc = None
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_cs(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(np.maximum(cs_pc, 0.0))
            x = _avg_pool2(x)
            y = _avg_pool2(y)
    stack = np.stack(mcs + [np.maximum(ssim_pc, 0.0)])  # (levels, C)
    per_channel = np.prod(stack ** _WEIGHTS[:, None], axis=0)
    return float(per_channel.mean())
