"""The warps of the model path: CUDA kernels on the GPU, plain versions on the CPU.

`flow_warp` and `grouped_warp` launch the hand-written kernels of
`csrc/warp.cu` (built at first use, see build.py) for CUDA tensors and take
the plain PyTorch versions of `ops/warp.py` for CPU tensors.  A CUDA tensor
launches its kernel or raises: there is no fallback.  The kernels stand for
the JAX package's Pallas warp kernels and their tier dispatch
(`lssvc_tpu/ops/warp_pallas.py` `flow_warp_auto`, `grouped_warp_auto`):
one gather kernel is exact for every flow magnitude, so no tier exists
here and callers pass no flow bound.  `flow_warp_pair` warps two tensors
by one flow in a single `flow_warp` launch (the kernel's pair entry point),
with no concat of its sources and no slices of its output.

Each wrapper counts its kernel launches in `<wrapper>.launches`, so a run
can show that the model path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .warp import flow_warp as flow_warp_plain
from .warp import grouped_warp_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("warp")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.lssvc_flow_warp.argtypes = [vp, vp, vp, i64, i32, i32, i32, i32,
                                        vp]
        lib.lssvc_flow_warp.restype = i32
        lib.lssvc_flow_warp_pair.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32,
                                             i32, i32, i32, vp]
        lib.lssvc_flow_warp_pair.restype = i32
        lib.lssvc_grouped_warp.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32,
                                           i32, i32, i32, i32, vp]
        lib.lssvc_grouped_warp.restype = i32
        _LIB = lib
    return _LIB


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_grid(n, h):
    # the kernels put images on gridDim.z and rows on gridDim.y
    if n > 65535 or h > 65535:
        raise ValueError(f"batch {n} or height {h} past 65535")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flow_warp(x, flow):
    """Bilinear backward warp (border clamp, align_corners=True).

    x: (N, H, W, C) float32 or bfloat16; flow: (N, H, W, 2) pixel (dx, dy),
    float32.  Output in x's dtype, computed in float32."""
    if x.device.type == "cpu":
        return flow_warp_plain(x, flow)
    n, h, w, c = x.shape
    x = x.contiguous()
    flow = flow.contiguous()
    _check("x", x, (n, h, w, c), _DTYPES, x.device)
    _check("flow", flow, (n, h, w, 2), (torch.float32,), x.device)
    _check_grid(n, h)
    out = torch.empty_like(x)
    err = _lib().lssvc_flow_warp(
        x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
        _DTYPES[x.dtype], _stream(x))
    _raise_on(err, "flow_warp")
    flow_warp.launches += 1
    return out


flow_warp.launches = 0


def flow_warp_pair(a, b, flow):
    """Warp two tensors of one dtype by the same flow: on the GPU one
    `flow_warp` launch into two outputs (counted on `flow_warp.launches`);
    on the CPU concat, plain warp, split, which equals two warps bit for bit
    because warping is exact per channel."""
    if a.device.type == "cpu":
        ca = a.shape[-1]
        out = flow_warp_plain(torch.cat([a, b], dim=-1), flow)
        return out[..., :ca], out[..., ca:]
    n, h, w, ca = a.shape
    cb = b.shape[-1]
    a, b, flow = a.contiguous(), b.contiguous(), flow.contiguous()
    _check("a", a, (n, h, w, ca), _DTYPES, a.device)
    _check("b", b, (n, h, w, cb), (a.dtype,), a.device)
    _check("flow", flow, (n, h, w, 2), (torch.float32,), a.device)
    _check_grid(n, h)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    err = _lib().lssvc_flow_warp_pair(
        a.data_ptr(), b.data_ptr(), flow.data_ptr(), out_a.data_ptr(),
        out_b.data_ptr(), n, h, w, ca, cb, _DTYPES[a.dtype], _stream(a))
    _raise_on(err, "flow_warp_pair")
    flow_warp.launches += 1
    return out_a, out_b


def grouped_warp(x, flow_x, flow_y, mask, group_num: int):
    """OffsetDiversity grouped warp with mask, block-layout output.

    x: (N, H, W, C_src) float32 or bfloat16; flow_x, flow_y, mask:
    (N, H, W, go) float32.  Output (N, H, W, go*cg) in x's dtype, channel
    c' = k*go + j = mask_j * (source channel (j % group_num)*cg + k warped
    by unit j's flow)."""
    if x.device.type == "cpu":
        return grouped_warp_plain(x, flow_x, flow_y, mask, group_num)
    n, h, w, c_src = x.shape
    go = flow_x.shape[-1]
    if c_src % group_num or go % group_num:
        raise ValueError(f"C_src={c_src} and go={go} must be multiples of "
                         f"group_num={group_num}")
    x, flow_x, flow_y, mask = (t.contiguous()
                               for t in (x, flow_x, flow_y, mask))
    _check("x", x, (n, h, w, c_src), _DTYPES, x.device)
    for name, t in (("flow_x", flow_x), ("flow_y", flow_y), ("mask", mask)):
        _check(name, t, (n, h, w, go), (torch.float32,), x.device)
    _check_grid(n, h)
    out = torch.empty((n, h, w, go * (c_src // group_num)), dtype=x.dtype,
                      device=x.device)
    err = _lib().lssvc_grouped_warp(
        x.data_ptr(), flow_x.data_ptr(), flow_y.data_ptr(), mask.data_ptr(),
        out.data_ptr(), n, h, w, c_src, go, group_num, _DTYPES[x.dtype],
        _stream(x))
    _raise_on(err, "grouped_warp")
    grouped_warp.launches += 1
    return out


grouped_warp.launches = 0
