"""Core NN primitives on NHWC activations with torch-layout parameters.

Semantics match the JAX package's `lssvc_tpu/ops/nn.py` (and through it the
reference's Conv2d / ConvTranspose2d / PixelShuffle / pooling / GDN).  A
conv runs `F.conv2d` on `x.permute(0, 3, 1, 2)`: for a contiguous NHWC
tensor that is a channels_last view, which cuDNN takes as it is, and the
result permuted back is contiguous NHWC again.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F


def set_fp32_parity():
    """The fp32 parity mode: full-fp32, deterministic convolutions and
    matmuls.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits); the JAX package runs them at `Precision.HIGHEST`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # A stream's encoder and decoder (another process) must compute each
    # conv bit for bit alike: cuDNN's heuristic, never its timed choice,
    # and only algorithms that sum in a fixed order (`conv_transpose2d`
    # takes forward convs for the same reason)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


@contextlib.contextmanager
def fp32_matmul():
    """Full-f32 matrix products inside the block, whatever the global TF32
    setting (the JAX package's `Precision.HIGHEST` einsums); the setting is
    restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# Serving cap on OffsetDiversity's diversity offsets, in pixels (the JAX
# package's CLI preset, `ops/nn.py:104-128`).  Encoder and decoder compute
# offsets from decoded data, so the same cap keeps their streams in step.
# Here it is an explicit attribute of the model (`LSSVC.od_offset_cap`);
# None leaves the offsets uncapped, as training does.
OD_OFFSET_CAP_SERVING = 10.0


def od_offset_cap_from_env():
    """The CLIs' cap: `LSSVC_OD_OFFSET_CAP` px, read as the JAX package's
    CLI reads it (`ops/nn.py:106,123`): 10 by default, no cap for 0 or an
    empty value."""
    value = os.environ.get("LSSVC_OD_OFFSET_CAP", "10")
    return float(value) if value and float(value) else None


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    # channels_last output of a conv or pool: a free view back to NHWC
    return y.permute(0, 2, 3, 1).contiguous()


def pad_nhwc(x, pad_lrtb, value=0.0):
    """Pad/crop W (left, right) and H (top, bottom) of an NHWC tensor;
    negative entries crop, like torch.nn.functional.pad."""
    left, right, top, bottom = pad_lrtb
    if left == right == top == bottom == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def conv2d(x, w, b=None, stride=1, padding=None, groups=1):
    """2D convolution. x: NHWC, w: OIHW ((out, in/groups, kh, kw)).

    `padding` defaults to (k-1)//2 per axis; pass an int or (ph, pw)."""
    if padding is None:
        padding = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding,
                          groups=groups))


# A stride-2 3x3 transposed conv (padding 1, output padding 1) as one 2x2
# conv to 4x the channels and a pixel shuffle: output row 2m takes input
# row m through kernel row 1; output row 2m+1 takes rows m and m+1 through
# kernel rows 2 and 0 (and the same along columns).  Keys (phase, input
# offset) -> kernel index; the other pairs are zero taps.
_DECONV_TAPS = {(0, 0): 1, (1, 0): 2, (1, 1): 0}


@functools.lru_cache(maxsize=None)
def _deconv_gather(device) -> torch.Tensor:
    """(a, b, di, dj) flattened -> the 3x3 tap feeding it (9: zero), on
    `device`."""
    gather = np.full((2, 2, 2, 2), 9, np.int64)
    for (a, di), ti in _DECONV_TAPS.items():
        for (b, dj), tj in _DECONV_TAPS.items():
            gather[a, b, di, dj] = 3 * ti + tj
    return torch.from_numpy(gather.reshape(-1)).to(device)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=1):
    """torch ConvTranspose2d on NHWC `x`; w is the un-flipped (I, O, 3, 3)
    weight.  Computed as forward convolutions (stride 1: the flipped,
    transposed kernel; stride 2: `_DECONV_TAPS`), whose cuDNN algorithms
    all sum in a fixed order: its transposed-conv algorithm 0 adds with
    atomics, so a stream's encoder and decoder could disagree in the last
    bit.  Only the models' two configurations are taken."""
    cin, cout, kh, kw = w.shape
    if (kh, kw, padding) == (3, 3, 1) and (stride, output_padding) == (1, 0):
        return conv2d(x, w.permute(1, 0, 2, 3).flip(2, 3), b)
    if (kh, kw, padding) != (3, 3, 1) or (stride, output_padding) != (2, 1):
        raise ValueError(f"conv_transpose2d of a {kh}x{kw} kernel, stride "
                         f"{stride}, padding {padding}, output padding "
                         f"{output_padding}: not a configuration of the models")
    taps = torch.cat([w.reshape(cin, cout, 9), w.new_zeros(cin, cout, 1)], -1)
    # (I, O, a, b, di, dj) -> (O, a, b, I, di, dj): out channel o*4 + 2a + b,
    # pixel_shuffle's order
    w2 = taps[:, :, _deconv_gather(w.device)].reshape(cin, cout, 2, 2, 2, 2) \
        .permute(1, 2, 3, 0, 4, 5).reshape(4 * cout, cin, 2, 2)
    b2 = None if b is None else b.repeat_interleave(4)
    return pixel_shuffle(conv2d(pad_nhwc(x, (0, 1, 0, 1)), w2, b2,
                                padding=0), 2)


def pixel_shuffle(x, r: int):
    """Sub-pixel upsample (torch PixelShuffle) on NHWC: C*r^2 -> C, HxW -> rHxrW."""
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, oc, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, oc)


def avg_pool2d(x, k: int = 2):
    return _nhwc(F.avg_pool2d(_nchw(x), k))


def max_pool2d(x, k: int = 2):
    return _nhwc(F.max_pool2d(_nchw(x), k))


def ste_round(x):
    """round() with a straight-through gradient, written as the JAX package
    writes it (`x + stop_gradient(round(x) - x)`) so the forward values
    match; torch.round rounds half to even like jnp.round."""
    return x + (torch.round(x) - x).detach()


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def relu(x):
    return F.relu(x)


# ---------------------------------------------------------------------------
# GDN (the JAX package's `ops/nn.py:356-379` reparameterisation)

_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_MIN = 1e-6
_BETA_BOUND = (_BETA_MIN + _PEDESTAL) ** 0.5
_GAMMA_BOUND = _REPARAM_OFFSET


def gdn(x, beta, gamma, inverse: bool = False):
    """Generalized divisive normalization over NHWC channels.

    beta: (C,), gamma: (C_out, C_in), both in the sqrt-reparameterized space
    the torch models store.  norm = x^2 @ gamma^T + beta; out = x * sqrt(norm)
    (inverse) or x * rsqrt(norm)."""
    beta = torch.square(torch.clamp(beta, min=_BETA_BOUND)) - _PEDESTAL
    gamma = torch.square(torch.clamp(gamma, min=_GAMMA_BOUND)) - _PEDESTAL
    norm = torch.matmul(torch.square(x), gamma.t()) + beta
    if inverse:
        return x * torch.sqrt(norm)
    return x * torch.rsqrt(norm)
