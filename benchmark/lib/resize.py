"""MATLAB-style bicubic resize: a frozen copy of the program's
`lssvc_tpu_torch/utils/resize.py` (commit 4d8626f), with its f32 product
(`ops/nn.py` `matmul_highest`) copied in."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch



def matmul_highest(a, b):
    """a @ b in full f32 whatever the TF32 flags: on the card in float64
    rounded to f32 once (the program's `ops/nn.py` `matmul_highest`)."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(a.dtype)


def _cubic_contribution(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax * ax2
    range_01 = (ax <= 1).astype(x.dtype)
    range_12 = ((ax > 1) & (ax <= 2)).astype(x.dtype)
    cont_01 = ((a + 2) * ax3 - (a + 3) * ax2 + 1) * range_01
    cont_12 = ((a * ax3) - (5 * a * ax2) + (8 * a * ax) - (4 * a)) * range_12
    return cont_01 + cont_12


def _reflect_index(idx: np.ndarray, size: int) -> np.ndarray:
    """MATLAB reflect, boundary elements used twice: maps any integer index
    into [0, size) as ... 1,0 | 0,1,..,n-1 | n-1,n-2 ..."""
    period = 2 * size
    idx = np.mod(idx, period)
    return np.where(idx < size, idx, period - 1 - idx)


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, antialiasing: bool) -> np.ndarray:
    """Dense (out_size, in_size) float32 resize matrix for one axis."""
    scale = out_size / in_size
    kernel_size = 4
    if antialiasing and scale < 1:
        antialiasing_factor = scale
        kernel_size = math.ceil(kernel_size / antialiasing_factor)
    else:
        antialiasing_factor = 1.0
    kernel_size += 2  # a margin on both sides, as in MATLAB

    pos = np.linspace(0, out_size - 1, out_size, dtype=np.float32)
    pos = (pos + 0.5) / scale - 0.5
    base = np.floor(pos) - (kernel_size // 2) + 1
    dist = pos - base
    base = base.astype(np.int64)

    # weight[k, i] = cubic((dist_i - k) * af), normalised over k
    taps = np.arange(kernel_size, dtype=np.float32)[:, None]
    buffer_pos = (dist[None, :] - taps) * antialiasing_factor
    weight = _cubic_contribution(buffer_pos.astype(np.float32))
    weight = weight / weight.sum(axis=0, keepdims=True)

    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for k in range(kernel_size):
        src = _reflect_index(base + k, in_size)
        # several taps can fold onto one source index
        np.add.at(mat, (np.arange(out_size), src), weight[k])
    return mat


@functools.lru_cache(maxsize=64)
def resize_matrices(in_hw, out_hw, antialiasing: bool, device: torch.device):
    """(H matrix, W^T matrix) as f32 tensors on `device`, cached by shape."""
    mh = _resize_matrix(in_hw[0], out_hw[0], antialiasing)
    mw = _resize_matrix(in_hw[1], out_hw[1], antialiasing)
    return (torch.from_numpy(mh).to(device),
            torch.from_numpy(np.ascontiguousarray(mw.T)).to(device))


def imresize(x: torch.Tensor, scale=None, sizes=None, kernel: str = "cubic",
             antialiasing: bool = True) -> torch.Tensor:
    """Bicubic resize of the trailing two axes of `x` (2-D to 4-D).

    Exactly one of `scale` (float) or `sizes` ((H, W)) is given.  Returns a
    tensor of the same rank and dtype; an integer dtype is rounded and
    saturated to its range (bicubic overshoot next to hard edges must not
    wrap)."""
    if kernel != "cubic":
        raise ValueError("only the cubic kernel is supported")
    if (scale is None) == (sizes is None):
        raise ValueError("exactly one of scale or sizes must be specified")
    h, w = x.shape[-2], x.shape[-1]
    if sizes is None:
        sizes = (math.ceil(h * scale), math.ceil(w * scale))
    out_h, out_w = int(sizes[0]), int(sizes[1])
    if (out_h, out_w) == (h, w):
        return x

    mh, mw_t = resize_matrices((h, w), (out_h, out_w), antialiasing, x.device)
    # H axis: (outH, H) @ (..., H, W); then W axis: (..., outH, W) @ (W, outW)
    y = matmul_highest(matmul_highest(mh, x.float()), mw_t)
    if x.dtype == torch.float32:
        return y
    if not x.dtype.is_floating_point:
        # clamped in f64: f32 rounds a 32-bit bound such as 2^31 - 1 up and
        # out of range
        info = torch.iinfo(x.dtype)
        y = torch.clamp(torch.round(y).double(), info.min, info.max)
    return y.to(x.dtype)
