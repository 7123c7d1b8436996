"""Quality metrics on the host: PSNR from an MSE and per-plane (MS-)SSIM
(the GOP loop's part of the JAX package's `utils/metrics.py`, numpy and
scipy only).

The reference's conventions (`src/utils/metric.py`, `test.py:107-118,
290-291`): per-plane SSIM through an 11x11 sigma=1.5 Gaussian window
(fftconvolve); MS-SSIM with the HM-style level and weight fallback for
small frames (<176 -> 4 levels, <88 -> 3 levels).  The algorithm follows the DCVC metric code
(Microsoft, MIT license, vendored by the reference), Wang et al.'s MS-SSIM
with the HM/JCT-VC small-frame fallback.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage, signal

# MS-SSIM per-level weights: Wang et al. for 5 levels; HM-style
# renormalized fallbacks for frames too small to downsample 4x / 3x.
_MSSSIM_WEIGHTS = {
    5: np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333]),
    4: np.array([0.0517, 0.3295, 0.3462, 0.2726]),
    3: np.array([0.2, 0.5, 0.3]),
}


def fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """MATLAB-convention Gaussian window, normalized to sum 1."""
    ax = np.arange(-size // 2 + 1, size // 2 + 1, dtype=np.float64)
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def calc_ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 255):
    """Returns (ssim_map, cs_map) for two 2D arrays.

    The five local moments (two means, three second moments) share one
    batched FFT convolution: identical FFT sizes per plane, so the
    result is bit-identical to five separate fftconvolve calls while
    doing one forward/inverse transform pass over a stacked input.
    """
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    window = fspecial_gauss(11, 1.5)
    planes = np.stack([a, b, a * a, b * b, a * b])
    mu1, mu2, e11, e22, e12 = signal.fftconvolve(
        window[None], planes, mode="valid", axes=(1, 2))
    var1 = e11 - mu1 * mu1
    var2 = e22 - mu2 * mu2
    cov = e12 - mu1 * mu2
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cs_map = (2.0 * cov + c2) / (var1 + var2 + c2)
    lum = (2.0 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)
    return lum * cs_map, cs_map


def _halve(img: np.ndarray) -> np.ndarray:
    """One MS-SSIM pyramid step: 2x2 mean (reflect padding), stride 2."""
    kernel = np.full((2, 2), 0.25)
    return ndimage.convolve(img, kernel, mode="reflect")[::2, ::2]


def _msssim_levels(height: int, width: int) -> int:
    if height < 88 or width < 88:
        return 3
    if height < 176 or width < 176:
        return 4
    return 5


def calc_msssim(img1: np.ndarray, img2: np.ndarray,
                data_range: float = 255) -> float:
    """MS-SSIM for two 2D arrays with HM small-frame fallback."""
    level = _msssim_levels(*img1.shape)
    weight = _MSSSIM_WEIGHTS[level]
    im1 = img1.astype(np.float64)
    im2 = img2.astype(np.float64)
    mean_ssim = np.empty(level)
    mean_cs = np.empty(level)
    for lv in range(level):
        ssim_map, cs_map = calc_ssim(im1, im2, data_range=data_range)
        mean_ssim[lv] = ssim_map.mean()
        mean_cs[lv] = cs_map.mean()
        if lv + 1 < level:
            im1, im2 = _halve(im1), _halve(im2)
    # contrast/structure terms at all coarser levels, luminance only at
    # the coarsest
    factors = np.concatenate([mean_cs[:-1], mean_ssim[-1:]])
    return float(np.prod(factors ** weight))


def mse_to_psnr(mse: float, data_range: float = 1) -> float:
    if not np.isfinite(mse):
        # NaN/inf reconstruction must surface as NaN, not saturate to the
        # identical-frames sentinel: `NaN > 1e-10` is False, and one
        # silently-999.9 frame averaged into a sequence reads as a
        # plausible high-PSNR result (observed: an int8 eval with one NaN
        # frame in twelve reported 89 dB)
        return float("nan")
    if mse > 1e-10:
        return float(10 * np.log10(data_range * data_range / mse))
    return 999.9  # identical frames (reference sentinel, `test.py:107-112`)

