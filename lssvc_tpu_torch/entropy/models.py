"""Video-side bit estimation (the JAX package's `entropy/models.py:34-78`).

  * factorized "Bitparm" density (4-layer monotone MLP per channel);
  * Laplace-CDF interval likelihood for the conditional latents.

Bits use the reference's clamp conventions (probs + 1e-5, bits clipped to
[0, 50] per element).  Activations are NHWC; Bitparm parameters are held in
the torch layout (1, C, 1, 1) and viewed as (1, 1, 1, C) here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG2 = math.log(2.0)


def bitparm_forward(p, x, final: bool):
    """One Bitparm layer; p scopes h/b(/a) of shape (1, C, 1, 1)."""
    h = p("h").reshape(1, 1, 1, -1)
    b = p("b").reshape(1, 1, 1, -1)
    if final:
        return torch.sigmoid(x * F.softplus(h) + b)
    a = p("a").reshape(1, 1, 1, -1)
    x = x * F.softplus(h) + b
    return x + torch.tanh(x) * torch.tanh(a)


def bit_estimator_forward(p, x):
    """Factorized CDF F(x) in [0, 1]; x NHWC, params f1..f4."""
    x = bitparm_forward(p.sub("f1"), x, final=False)
    x = bitparm_forward(p.sub("f2"), x, final=False)
    x = bitparm_forward(p.sub("f3"), x, final=False)
    return bitparm_forward(p.sub("f4"), x, final=True)


def likelihood_to_bits(probs):
    """sum(clamp(-log(p + 1e-5)/log 2, 0, 50)) — reference bit-count clamps."""
    bits = torch.clamp(-torch.log(probs + 1e-5) / LOG2, 0.0, 50.0)
    return torch.sum(bits)


def factorized_bits(p, z):
    """Total bits of z under the factorized Bitparm model (z already quantized)."""
    prob = bit_estimator_forward(p, z + 0.5) - bit_estimator_forward(p, z - 0.5)
    return likelihood_to_bits(prob), prob


def laplace_cdf(x, scale):
    """CDF of Laplace(0, scale): 0.5 - 0.5*sign(x)*expm1(-|x|/scale)."""
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / scale)


def laplace_bits(y, sigma):
    """Interval likelihood bits under Laplace(0, sigma) (sigma clamped)."""
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    probs = laplace_cdf(y + 0.5, sigma) - laplace_cdf(y - 0.5, sigma)
    return likelihood_to_bits(probs), probs
