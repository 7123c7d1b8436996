"""The width-packed convolution domain (the JAX package's `ops/packed.py`).

A width-packed tensor is (N, H, W/p, p*C): p horizontally adjacent pixels
stacked into the channel dim, packed channel (w % p)*C + c.  NHWC
flattens (W, C) row-major, so packing a C-contiguous NHWC tensor is a pure
reshape: the same bytes.  A k-wide stride-s conv on the unpacked tensor is
exactly a k'-wide stride-s conv on the packed tensor with a
block-structured kernel (`pack_kernel`), so a conv stack can run in the
packed domain.

On the TPU the packed domain saves lane padding (a 48-channel tensor pads
to 128 lanes).  The H100 pads nothing, and packing doubles the MACs of the
packed sites, so here it is a mode for parity with the JAX package's
serving modes, not a speed-up.

`pack_kernel` / `pack_depthwise_kernel` / `pack_bias` take and return
numpy arrays in the JAX package's HWIO layout, bit for bit as there;
`pack_kernel_oihw` / `pack_depthwise_kernel_oihw` are the same scatter for
the port's OIHW torch weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .nn import conv2d


def pack_width(x, p: int):
    """(N, H, W, C) -> (N, H, W/p, p*C); packed channel = (w % p)*C + c.
    A view of a C-contiguous tensor."""
    n, h, w, c = x.shape
    if w % p:
        raise ValueError(f"width {w} is not a multiple of {p}")
    return x.reshape(n, h, w // p, p * c)


def unpack_width(x, p: int):
    """(N, H, Wp, p*C) -> (N, H, Wp*p, C). Inverse of `pack_width`."""
    n, h, wp, pc = x.shape
    if pc % p:
        raise ValueError(f"{pc} channels is not a multiple of {p}")
    return x.reshape(n, h, wp * p, pc // p)


def _taps(kw: int, p: int, stride: int):
    """The scatter of a kw-wide kernel into the packed domain: the packed
    width kw_p, the packed padding (pad_l, pad_r), and for each output slot
    so and tap d the packed tap t and input slot si.

    Output real column x_out = p*xp_out + so reads input column
    stride*x_out + d (d in [-kw//2, kw//2]); q = stride*so + d = p*T + si
    places tap d of output slot so at packed tap T, input slot si."""
    if kw % 2 != 1:
        raise ValueError(f"kernel width {kw} is not odd")
    r = kw // 2
    t_min = (-r) // p  # floor division
    t_max = (stride * (p - 1) + r) // p
    scatter = []
    for so in range(p):
        for d in range(-r, r + 1):
            q = stride * so + d
            t = q // p
            scatter.append((so, d + r, t - t_min, q - p * t))
    return t_max - t_min + 1, (-t_min, t_max - (stride - 1)), scatter


def pack_kernel(w, p: int, stride: int = 1):
    """Packed-domain equivalent of an HWIO (kh, kw, Cin, Cout) kernel with
    odd kw, torch padding kw//2 and width-stride `stride`: returns
    (packed_w, (pad_l, pad_r)) such that

        conv(pack_width(x, p), packed_w, stride, padding=((kh//2,)*2,
             (pad_l, pad_r))) == pack_width(conv(x, w, stride), p)

    exactly (the packed kernel scatters the original taps; untouched slots
    are zero)."""
    w = np.asarray(w)
    kh, kw, cin, cout = w.shape
    kw_p, pads, scatter = _taps(kw, p, stride)
    packed = np.zeros((kh, kw_p, p * cin, p * cout), dtype=w.dtype)
    for so, d, t, si in scatter:
        packed[:, t, si * cin:(si + 1) * cin,
               so * cout:(so + 1) * cout] += w[:, d]
    return packed, pads


def pack_depthwise_kernel(w, p: int, stride: int = 1):
    """Packed equivalent of a depthwise HWIO (kh, kw, 1, C) kernel,
    densified to (kh, kw_p, p*C, p*C) (+ padding)."""
    w = np.asarray(w)
    kh, kw, one, c = w.shape
    if one != 1:
        raise ValueError(f"depthwise kernel of shape {w.shape}")
    dense = np.zeros((kh, kw, c, c), dtype=w.dtype)
    idx = np.arange(c)
    dense[:, :, idx, idx] = w[:, :, 0, :]
    return pack_kernel(dense, p, stride)


def pack_bias(b, p: int):
    """(C,) bias -> (p*C,) packed bias (numpy or torch)."""
    if isinstance(b, torch.Tensor):
        return b.repeat(p)
    return np.tile(np.asarray(b), (p,))


def pack_kernel_oihw(w: torch.Tensor, p: int, stride: int = 1):
    """`pack_kernel` of an OIHW torch weight: (p*Cout, p*Cin, kh, kw_p)
    on w's device and dtype, and (pad_l, pad_r)."""
    cout, cin, kh, kw = w.shape
    kw_p, pads, scatter = _taps(kw, p, stride)
    packed = w.new_zeros((p * cout, p * cin, kh, kw_p))
    for so, d, t, si in scatter:
        packed[so * cout:(so + 1) * cout, si * cin:(si + 1) * cin, :, t] += \
            w[:, :, :, d]
    return packed, pads


def pack_depthwise_kernel_oihw(w: torch.Tensor, p: int, stride: int = 1):
    """`pack_depthwise_kernel` of a depthwise (C, 1, kh, kw) torch weight."""
    c, one, kh, kw = w.shape
    if one != 1:
        raise ValueError(f"depthwise kernel of shape {tuple(w.shape)}")
    dense = w.new_zeros((c, c, kh, kw))
    idx = torch.arange(c, device=w.device)
    dense[idx, idx] = w[:, 0]
    return pack_kernel_oihw(dense, p, stride)


def packed_conv2d(x_packed, packed_w, b_packed=None, stride: int = 1,
                  pad_lr=(1, 1)):
    """A packed-domain conv (`ops.nn.conv2d`, the current mode) with the
    packed width padding; packed_w is OIHW.  An asymmetric padding (the
    stride-2 kernels) pads the input first."""
    kh = packed_w.shape[2]
    pad_l, pad_r = pad_lr
    if pad_l != pad_r:
        x_packed = F.pad(x_packed, (0, 0, pad_l, pad_r))
        pad_l = 0
    return conv2d(x_packed, packed_w, b_packed, stride=stride,
                  padding=(kh // 2, pad_l))
