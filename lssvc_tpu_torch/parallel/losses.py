"""Training losses (the JAX package's `parallel/losses.py`).

`rd_loss_intra` mirrors the reference's RDLossIntra
(`src/IntraModules/rd_loss_intra.py:6-37`): lambda * 255^2 * MSE + bpp,
with the bpp split by latent.  `ms_ssim` is a differentiable MS-SSIM on
NHWC batches, as the JAX package's (the reference fine-tunes with
pytorch_msssim's MS_SSIM module for the same purpose).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG2 = math.log(2.0)
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def rd_loss_intra(z_likelihood, y_likelihood, x_hat, target, lmbda=1e-2):
    """target, x_hat NHWC; the likelihoods of any shape."""
    n, h, w, _ = target.shape
    num_pixels = n * h * w
    out = {}
    out["z_bpp_loss"] = torch.sum(torch.log(z_likelihood)) / (-LOG2 * num_pixels)
    out["y_bpp_loss"] = torch.sum(torch.log(y_likelihood)) / (-LOG2 * num_pixels)
    out["bpp_loss"] = out["z_bpp_loss"] + out["y_bpp_loss"]
    out["mse_loss"] = torch.mean(torch.square(x_hat - target))
    out["loss"] = lmbda * 255.0 ** 2 * out["mse_loss"] + out["bpp_loss"]
    return out


def _gaussian_window(size: int, sigma: float = 1.5, device=None):
    coords = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter2d_valid(x, win):
    """Separable valid-mode filtering of NHWC `x`, one channel at a time."""
    k, c = win.shape[0], x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    xc = F.conv2d(xc, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    xc = F.conv2d(xc, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return xc.permute(0, 2, 3, 1)


def _ssim_cs(x, y, win, data_range, K=(0.01, 0.03)):
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2
    mu1 = _filter2d_valid(x, win)
    mu2 = _filter2d_valid(y, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d_valid(x * x, win) - mu1_sq
    s2 = _filter2d_valid(y * y, win) - mu2_sq
    s12 = _filter2d_valid(x * y, win) - mu12
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim = ((2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    return torch.mean(ssim), torch.mean(cs)


def _avg2(x):
    """2x2 mean, valid (the JAX package's reduce_window sum / 4), NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11):
    """Differentiable MS-SSIM on NHWC batches."""
    win = _gaussian_window(win_size, device=x.device)
    levels = len(_MSSSIM_WEIGHTS)
    zero = x.new_zeros(())
    mcs = []
    ssim_val = zero
    for i in range(levels):
        ssim_val, cs = _ssim_cs(x, y, win, data_range)
        if i < levels - 1:
            # the JAX package's jnp.maximum (a tie halves the gradient)
            mcs.append(torch.maximum(cs, zero))
            h, w = x.shape[1] - x.shape[1] % 2, x.shape[2] - x.shape[2] % 2
            x, y = _avg2(x[:, :h, :w]), _avg2(y[:, :h, :w])
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=x.device)
    return torch.prod(torch.stack(mcs) ** weights[:levels - 1]) * \
        (torch.maximum(ssim_val, zero) ** weights[-1])
