"""IntraNoAR — the hyperprior intra codec of the base layer (the JAX
package's `models/intra_noar.py:36-165`, estimated bits).

A Cheng-style residual-block hyperprior autoencoder at N=192, with a
factorized EntropyBottleneck on z and a Gaussian conditional on y
(reference `priors.py:112-452`).  Plain PyTorch: the JAX package runs it
as XLA and reaches no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..convert import P
from ..entropy.models import (
    entropy_bottleneck_forward,
    gaussian_conditional_likelihood,
)
from ..ops import leaky_relu, ste_round
from .base import Model
from .components import (
    conv,
    residual_block,
    residual_block_upsample,
    residual_block_with_stride,
    subpel_conv,
)

LOG2 = math.log(2.0)


def g_a(p, x):
    x = residual_block_with_stride(p.sub("0"), x)
    x = residual_block(p.sub("1"), x)
    x = residual_block_with_stride(p.sub("2"), x)
    x = residual_block(p.sub("3"), x)
    x = residual_block_with_stride(p.sub("4"), x)
    x = residual_block(p.sub("5"), x)
    return conv(p.sub("6"), x, stride=2)


def h_a(p, y):
    x = leaky_relu(conv(p.sub("0"), y))
    x = leaky_relu(conv(p.sub("2"), x))
    x = leaky_relu(conv(p.sub("4"), x, stride=2))
    x = leaky_relu(conv(p.sub("6"), x))
    return conv(p.sub("8"), x, stride=2)


def h_s(p, z_hat):
    x = leaky_relu(conv(p.sub("0"), z_hat))
    x = leaky_relu(subpel_conv(p.sub("2"), x, 2))
    x = leaky_relu(conv(p.sub("4"), x))
    x = leaky_relu(subpel_conv(p.sub("6"), x, 2))
    return conv(p.sub("8"), x)


def g_s(p, y_hat):
    x = residual_block(p.sub("0"), y_hat)
    x = residual_block_upsample(p.sub("1"), x)
    x = residual_block(p.sub("2"), x)
    x = residual_block_upsample(p.sub("3"), x)
    x = residual_block(p.sub("4"), x)
    x = residual_block_upsample(p.sub("5"), x)
    x = residual_block(p.sub("6"), x)
    return subpel_conv(p.sub("7"), x, 2)


def analysis(params, x):
    """x NHWC -> (y, z)."""
    p = P(params)
    y = g_a(p.sub("g_a"), x)
    z = h_a(p.sub("h_a"), y)
    return y, z


def hyper_synthesis_quantize(params, y, z):
    """EntropyBottleneck round trip, then the Gaussian conditional's
    quantisation.  Returns (y_hat, z_hat, y_likelihoods, z_likelihoods,
    scales, means)."""
    p = P(params)
    z_hat, z_lik = entropy_bottleneck_forward(p.sub("entropy_bottleneck"), z)
    gaussian_params = h_s(p.sub("h_s"), z_hat)
    n_half = gaussian_params.shape[-1] // 2
    scales_hat = gaussian_params[..., :n_half]
    means_hat = gaussian_params[..., n_half:]
    y_hat = ste_round(y - means_hat) + means_hat
    y_lik = gaussian_conditional_likelihood(y_hat, scales_hat, means_hat)
    return y_hat, z_hat, y_lik, z_lik, scales_hat, means_hat


def forward(params, x):
    """Eval forward with estimated bits: x_hat, y_hat, bits and the
    intermediates."""
    y, z = analysis(params, x)
    y_hat, z_hat, y_lik, z_lik, scales_hat, means_hat = \
        hyper_synthesis_quantize(params, y, z)
    x_hat = g_s(P(params).sub("g_s"), y_hat)
    bits = (torch.sum(torch.log(y_lik)) + torch.sum(torch.log(z_lik))) / (-LOG2)
    return {
        "x_hat": x_hat,
        "y_hat": y_hat,
        "y": y,
        "z": z,
        "z_hat": z_hat,
        "scales_hat": scales_hat,
        "means_hat": means_hat,
        "bit": bits,
    }


class IntraNoAR(Model):
    """Base-layer I-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for)."""

    def __init__(self, params: dict, device="cuda"):
        super().__init__(params, device=device)
        # g_s.0.conv1 is an OIHW (N, N, 3, 3) weight
        self.N = int(params["g_s.0.conv1.weight"].shape[0])

    @torch.no_grad()
    def forward(self, x):
        return forward(self.flat_params(), x)

    def get_layer_information(self, x):
        """BL information for IntraSS's conditioning (`priors.py:368-388`)."""
        out = self.forward(x)
        pixel_num = x.shape[0] * x.shape[1] * x.shape[2]
        return {
            "bits": out["bit"],
            "mse": torch.mean(torch.square(x - out["x_hat"])),
            "bpp": out["bit"] / pixel_num,
            "x_hat": out["x_hat"],
            "y_hat": out["y_hat"],
        }
