"""Bit estimation and the stream path's scale tables (the JAX package's
`entropy/models.py:34-150,231-256`).

Video side:

  * factorized "Bitparm" density (4-layer monotone MLP per channel);
  * Laplace-CDF interval likelihood for the conditional latents.

Image side (the I-frame models):

  * erfc Gaussian conditional likelihood;
  * Ballé factorized EntropyBottleneck (`_logits_cumulative`).

The real-bitstream path maps each predicted scale to a row of a CDF table
(`build_indexes_video` / `build_indexes_img`; the tables themselves are
built in `entropy/coder.py`).

Bits use the reference's clamp conventions (probs + 1e-5, bits clipped to
[0, 50] per element).  Every bound is `torch.maximum` / `torch.minimum`,
as the JAX package's `jnp.maximum` and `jnp.clip`: at a tie each side
takes half the gradient (`torch.clamp` would give the input all of it),
which latent RDO (`models/rdo.py`) and training differentiate.  Activations are NHWC; Bitparm
parameters are held in the torch layout (1, C, 1, 1) and viewed as
(1, 1, 1, C) here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nn import clip, matmul_highest, ste_round

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
    bits = clip(-torch.log(probs + 1e-5) / LOG2, 0.0, 50.0)
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
    sigma = clip(sigma, 1e-5, 1e10)
    probs = laplace_cdf(y + 0.5, sigma) - laplace_cdf(y - 0.5, sigma)
    return likelihood_to_bits(probs), probs


# ---------------------------------------------------------------------------
# Gaussian conditional (image side)

def _std_cumulative(x):
    """0.5 * erfc(-x / sqrt(2)): the standard normal CDF, robust in the tails."""
    return 0.5 * torch.special.erfc(-(2.0 ** -0.5) * x)


def gaussian_conditional_likelihood(inputs, scales, means=None,
                                    scale_bound: float = 0.11,
                                    likelihood_bound: float = 1e-9):
    """P(round(x) | N(means, scales^2)) by half-interval integration."""
    values = inputs - means if means is not None else inputs
    scales = torch.maximum(scales, scales.new_tensor(scale_bound))
    values = torch.abs(values)
    upper = _std_cumulative((0.5 - values) / scales)
    lower = _std_cumulative((-0.5 - values) / scales)
    likelihood = upper - lower
    if likelihood_bound > 0:
        likelihood = torch.maximum(likelihood,
                                   likelihood.new_tensor(likelihood_bound))
    return likelihood


# ---------------------------------------------------------------------------
# EntropyBottleneck (Ballé factorized prior)

def entropy_bottleneck_logits(p, inputs, filters=(3, 3, 3, 3)):
    """_logits_cumulative: inputs (C, 1, N); matrices (C, fo, fi).  The
    products run in full f32 (the JAX package's `Precision.HIGHEST`)."""
    logits = inputs
    for i in range(len(filters) + 1):
        logits = matmul_highest(F.softplus(p(f"_matrices.{i}")), logits)
        logits = logits + p(f"_biases.{i}")
        if i < len(filters):
            logits = logits + (torch.tanh(p(f"_factors.{i}"))
                               * torch.tanh(logits))
    return logits


def entropy_bottleneck_forward(p, x, filters=(3, 3, 3, 3),
                               likelihood_bound: float = 1e-9):
    """Eval-mode forward: quantise around the medians, interval likelihood.

    x: NHWC.  Returns (x_hat NHWC, likelihood NHWC)."""
    n, h, w, c = x.shape
    med = p("quantiles")[:, 0, 1][:, None, None]  # (C, 1, 1)
    values = x.permute(3, 0, 1, 2).reshape(c, 1, -1)
    outputs = ste_round(values - med) + med

    lower = entropy_bottleneck_logits(p, outputs - 0.5, filters)
    upper = entropy_bottleneck_logits(p, outputs + 0.5, filters)
    sign = -torch.sign(lower + upper)
    likelihood = torch.abs(torch.sigmoid(sign * upper)
                           - torch.sigmoid(sign * lower))
    if likelihood_bound > 0:
        likelihood = torch.maximum(likelihood,
                                   likelihood.new_tensor(likelihood_bound))

    # canonical NHWC strides even where a dimension is 1 (`.contiguous()`
    # would keep the permuted ones): a conv's algorithm, and so its last
    # bits, can follow its input's strides, and the stream decoder's z_hat
    # (`IntraCoder.eb_decompress`) has these
    x_hat = outputs.reshape(c, n, h, w).permute(1, 2, 3, 0) \
        .clone(memory_format=torch.contiguous_format)
    like = likelihood.reshape(c, n, h, w).permute(1, 2, 3, 0)
    return x_hat, like


def entropy_bottleneck_aux_loss(p, tail_mass: float = 1e-9,
                                filters=(3, 3, 3, 3)):
    """Quantile auxiliary loss: |logits(quantiles) - target| summed (the JAX
    package's `entropy/models.py:153`, `img_entropy_models.py:478-481`);
    training minimises it to keep the quantiles at the tail-mass bounds."""
    quantiles = p("quantiles")  # (C, 1, 3)
    target = math.log(2 / tail_mass - 1)
    targets = quantiles.new_tensor([-target, 0.0, target])
    logits = entropy_bottleneck_logits(p, quantiles, filters)
    return torch.sum(torch.abs(logits - targets))


def fit_entropy_bottleneck_quantiles(p, tail_mass: float = 1e-9,
                                     filters=(3, 3, 3, 3), iters: int = 64):
    """The quantiles solved by per-channel bisection (the JAX package's
    `entropy/models.py:165-208`): `_logits_cumulative` is monotone in its
    input, so the aux loss's targets are hit exactly by root-finding.  The
    bracket doubles 13 times from [-1, 1] (a channel whose tails lie past
    +-8192 saturates there)."""
    target = math.log(2 / tail_mass - 1)
    q = p("quantiles")
    targets = q.new_tensor([-target, 0.0, target])
    lo = torch.full((q.shape[0], 1, 3), -1.0, dtype=torch.float32,
                    device=q.device)
    hi = -lo
    with torch.no_grad():
        for _ in range(13):
            v_lo = entropy_bottleneck_logits(p, lo, filters)
            v_hi = entropy_bottleneck_logits(p, hi, filters)
            lo = torch.where(v_lo > targets, lo * 2.0, lo)
            hi = torch.where(v_hi < targets, hi * 2.0, hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            too_low = entropy_bottleneck_logits(p, mid, filters) < targets
            lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi,
                                                                 mid)
    return 0.5 * (lo + hi)


def refit_quantiles(params: dict) -> dict:
    """A copy of a flat parameter dict with every EntropyBottleneck's
    quantiles re-solved by bisection (the JAX package's
    `entropy/models.py:211`, which its `train.py` applies when it saves an
    intra checkpoint): real-bitstream CDF tables come from the quantiles,
    and the aux loss is far from converged after a few hundred steps.  A
    bottleneck is a `<prefix>quantiles` key with a `<prefix>_matrices.0`
    sibling."""
    from ..convert import P

    out = dict(params)
    for k in params:
        if k.endswith("quantiles"):
            prefix = k[:-len("quantiles")]
            if prefix + "_matrices.0" in params:
                out[k] = fit_entropy_bottleneck_quantiles(P(params, prefix))
    return out


# ---------------------------------------------------------------------------
# Scale tables and index maps (the real-bitstream path)

def _log_scale_table(smin, smax, levels):
    return np.exp(np.linspace(math.log(smin), math.log(smax),
                              levels)).astype(np.float32)


# video side: 256 Laplace scales in [0.01, 64] (`video_entropy_models.py:247-258`)
GAUSSIAN_SCALE_TABLE_VIDEO = _log_scale_table(0.01, 64.0, 256)
# image side: 64 Gaussian scales in [0.11, 256] (`img_entropy_models.py:586-596`)
GAUSSIAN_SCALE_TABLE_IMG = _log_scale_table(0.11, 256.0, 64)


def build_indexes_video(scales):
    """Video-side scale -> table row (no +1 shift), int32 on the scales'
    device; computed in f32 whatever the scales' dtype (an index plane
    crosses to the host)."""
    log_min = math.log(0.01)
    step = (math.log(64.0) - log_min) / (256 - 1)
    idx = (torch.log(torch.clamp(scales.float(), min=1e-5)) - log_min) / step
    return torch.clamp(idx, 0, 255).to(torch.int32)


def build_indexes_img(scales):
    """Image-side map, with the reference's +1 bias
    (`img_entropy_models.py:689`), in f32."""
    log_min = math.log(0.11)
    step = (math.log(256.0) - log_min) / (64 - 1)
    idx = (torch.log(torch.clamp(scales.float(), min=1e-5)) - log_min) \
        / step + 1
    return torch.clamp(idx, 0, 63).to(torch.int32)
