"""Backward warping and bilinear resizing: the plain PyTorch versions.

`flow_warp` matches torch `grid_sample(mode='bilinear',
padding_mode='border', align_corners=True)` driven by a pixel-displacement
flow: the sample position is clip(index + flow, 0, S-1), gathered directly
(the JAX package's `lssvc_tpu/ops/warp.py`, same factored lerp).  These are
what the CPU runs and what the CUDA kernels of `warp_kernels.py` are held
against; the kernels repeat this arithmetic operation for operation.

The warps compute in float32 and return the input's dtype (a bf16 input is
upcast, warped, and rounded once at the end).  Integer sample indices are
clamped into range after conversion, so a NaN flow gives a NaN output and
never an out-of-range read.

`bilinear_resize` matches torch `interpolate(mode='bilinear',
align_corners=False)`, with the JAX package's 2-tap formulas for exact 2x
and 0.5x factors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .nn import clip, compute_dtype


def clamp_flow(flow, h, w):
    """Clamp a pixel-space flow field (..., 2: (dx, dy)) to +-(W, H).

    Exact under the border-clamping warp: a flow component beyond +-S lands
    outside [0, S-1] on the same side as one clamped at +-S.  Non-finite
    components map to the same saturated bounds (NaN -> 0)."""
    big = float(max(h, w))
    bound = torch.tensor([w, h], dtype=flow.dtype, device=flow.device)
    flow = torch.nan_to_num(flow, nan=0.0, posinf=big, neginf=-big)
    return torch.minimum(torch.maximum(flow, -bound), bound)


def _coords(f, size, pos):
    """Clamped sample position -> (i0, i1, frac) along one axis."""
    p = clip(pos + f, 0.0, size - 1.0)  # JAX's gradient on a bound
    p0 = torch.floor(p)
    frac = p - p0
    i0 = p0.to(torch.int64).clamp(0, size - 1)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    return i0, i1, frac


def _lerp(v00, v01, v10, v11, wx, wy):
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def flow_warp(x, flow):
    """Backward-warp NHWC `x` by pixel-space `flow` (N, H, W, 2: (dx, dy))."""
    n, h, w, c = x.shape
    dev = x.device
    flow = flow.float()
    iy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    x0, x1, wx = _coords(flow[..., 0], w, ix)
    y0, y1, wy = _coords(flow[..., 1], h, iy)

    flat = x.float().reshape(n * h * w, c)
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]

    def gather(yy, xx):
        return flat[(base + yy * w + xx).reshape(-1)].reshape(n, h, w, c)

    out = _lerp(gather(y0, x0), gather(y0, x1), gather(y1, x0),
                gather(y1, x1), wx[..., None], wy[..., None])
    return out.to(x.dtype)


def flow_warp_grouped(x, flow_x, flow_y):
    """Backward-warp with per-channel-group flows, block channel layout.

    x: (B, H, W, C) float32; flow_x/flow_y: (B, H, W, G) with C % G == 0 —
    channel c = k*G + g is warped by flow group g."""
    b, h, w, c = x.shape
    g = flow_x.shape[-1]
    r = c // g
    dev = x.device
    iy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    x0, x1, wx = _coords(flow_x, w, ix)
    y0, y1, wy = _coords(flow_y, h, iy)

    flat = x.reshape(b, h * w, c)

    def expand(t):
        # (B, H, W, G) -> (B, H, W, C) in block layout: channel k*G+g <- g
        return t if r == 1 else torch.cat([t] * r, dim=-1)

    def gather(yy, xx):
        idx = expand(yy * w + xx).reshape(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    return _lerp(gather(y0, x0), gather(y0, x1), gather(y1, x0),
                 gather(y1, x1), expand(wx), expand(wy))


def grouped_warp_plain(x, flow_x, flow_y, mask, group_num: int):
    """OffsetDiversity grouped warp with mask, block-layout output.

    x: (B, H, W, C_src); flow_x/flow_y/mask: (B, H, W, go).  Output channel
    c' = k*go + j is source channel (j % group_num)*cg + k warped by unit
    j's flow, times mask j (the JAX package's `warp_pallas.py:1372-1378`)."""
    cg = x.shape[-1] // group_num
    offset_num = flow_x.shape[-1] // group_num
    xf = x.float()
    planes = [xf[..., k::cg] for k in range(cg)]
    x_blk = torch.cat([p for plane in planes for p in (plane,) * offset_num],
                      dim=-1)
    warped = flow_warp_grouped(x_blk, flow_x.float(), flow_y.float())
    return (warped * torch.cat([mask.float()] * cg, dim=-1)).to(x.dtype)


def flow_warp_shift_sum(x, flow, bound: int):
    """`flow_warp` for |flow| <= `bound`, as a gather-free sum over the
    (2b+2)^2 integer taps: out = sum shift(x, dy, dx) * relu(1-|fy-dy|) *
    relu(1-|fx-dx|), with the effective (border-clamped) flow.  The JAX
    package's XLA formulation (`lssvc_tpu/ops/warp.py:320`), which its warp
    tier bench times; f32."""
    n, h, w, c = x.shape
    dev = x.device
    iy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    fy = (torch.clamp(iy + flow[..., 1], 0.0, h - 1.0) - iy)[..., None]
    fx = (torch.clamp(ix + flow[..., 0], 0.0, w - 1.0) - ix)[..., None]
    taps = 2 * bound + 2
    xp = torch.nn.functional.pad(x, (0, 0, bound, bound + 1, bound, bound + 1))
    acc = torch.zeros_like(x)
    for t in range(taps * taps):
        sy, sx = divmod(t, taps)
        wy = torch.clamp(1.0 - torch.abs(fy - (sy - bound)), min=0.0)
        wx = torch.clamp(1.0 - torch.abs(fx - (sx - bound)), min=0.0)
        acc = acc + xp[:, sy:sy + h, sx:sx + w] * (wy * wx)
    return acc


def grouped_warp_shift_sum(x, flow_x, flow_y, mask, group_num: int,
                           bound: int):
    """`grouped_warp_plain` for |flow| <= `bound` as a tap sum (block
    layout c' = k*go + j, mask applied): every unit shares each tap's
    shifted source, only the weights differ per unit.  The JAX package's
    XLA formulation (`lssvc_tpu/ops/warp.py:362`); f32."""
    n, h, w, c_src = x.shape
    go = flow_x.shape[-1]
    offset_num = go // group_num
    cg = c_src // group_num
    dev = x.device
    iy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    fy = torch.clamp(iy + flow_y, 0.0, h - 1.0) - iy  # (N, H, W, go)
    fx = torch.clamp(ix + flow_x, 0.0, w - 1.0) - ix
    planes = [x[..., k::cg] for k in range(cg)]  # (N, H, W, group_num) each
    x_blk = torch.cat([p for plane in planes for p in (plane,) * offset_num],
                      dim=-1)
    taps = 2 * bound + 2
    xp = torch.nn.functional.pad(x_blk,
                                 (0, 0, bound, bound + 1, bound, bound + 1))
    accs = [torch.zeros((n, h, w, go), dtype=x.dtype, device=dev)] * cg
    for t in range(taps * taps):
        sy, sx = divmod(t, taps)
        wy = torch.clamp(1.0 - torch.abs(fy - (sy - bound)), min=0.0)
        wx = torch.clamp(1.0 - torch.abs(fx - (sx - bound)), min=0.0)
        wgt = wy * wx
        xs = xp[:, sy:sy + h, sx:sx + w]
        accs = [accs[k] + xs[..., k * go:(k + 1) * go] * wgt
                for k in range(cg)]
    return torch.cat([a * mask for a in accs], dim=-1)


# ---------------------------------------------------------------------------
# Bilinear resizing (align_corners=False)

@functools.lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix reproducing torch bilinear align_corners=False."""
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    pos = np.maximum(pos, 0.0)
    x0 = np.floor(pos).astype(np.int64)
    w1 = (pos - x0).astype(np.float32)
    i0 = np.minimum(x0, in_size - 1)
    i1 = np.minimum(x0 + 1, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, i0), 1.0 - w1)
    np.add.at(mat, (rows, i1), w1)
    return mat


def bilinear_resize(x, out_hw):
    """Resize NHWC `x` to (out_h, out_w), torch bilinear align_corners=False.

    Exact 2x / 0.5x factors take the 2-tap lerp path; other factors apply
    the 2-banded resize matrices as dense products, matrices and operand in
    the current mode's compute dtype (`lssvc_tpu/ops/warp.py:276-285`),
    the result in x's dtype."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x
    if (out_h, out_w) == (2 * h, 2 * w):
        return bilinear_upsample2(x)
    if (2 * out_h, 2 * out_w) == (h, w):
        return bilinear_downsample2(x)
    dt = compute_dtype()
    mw = torch.from_numpy(_bilinear_matrix(w, out_w)).to(x.device, dt)

    def resize(rows, mat):
        mh = torch.from_numpy(np.ascontiguousarray(mat)).to(x.device, dt)
        y = torch.einsum("oh,nhwc->nowc", mh, rows.to(dt))
        return torch.einsum("pw,nowc->nopc", mw, y).to(x.dtype)

    return resize(x, _bilinear_matrix(h, out_h))


def _up2_axis(x, axis):
    """2x torch-bilinear along `axis`: even outputs 0.75*x[j] + 0.25*x[j-1],
    odd outputs 0.75*x[j] + 0.25*x[j+1], border-clamped."""
    n = x.shape[axis]
    xm = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    xp = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                   dim=axis)
    even = 0.75 * x + 0.25 * xm
    odd = 0.75 * x + 0.25 * xp
    stacked = torch.stack([even, odd], dim=axis + 1)
    new_shape = x.shape[:axis] + (2 * n,) + x.shape[axis + 1:]
    return stacked.reshape(new_shape)


def _upsample2(x):
    return _up2_axis(_up2_axis(x, 1), 2)


def bilinear_upsample2(x):
    """2x bilinear upsample (reference `bilinearupsacling`), 2-tap lerps."""
    return _upsample2(x)


def _downsample2(x):
    y = 0.5 * (x[:, 0::2] + x[:, 1::2])
    return 0.5 * (y[:, :, 0::2] + y[:, :, 1::2])


def bilinear_downsample2(x):
    """0.5x bilinear downsample (reference `bilineardownsacling`): the mean
    of the two source rows, then of the two source columns."""
    return _downsample2(x)
