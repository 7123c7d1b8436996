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

`packed_out=True` returns the width-packed layout (N, H, W/2, 2C) of
`ops/packed.py` (the Pallas kernels' `nhwc_out="p"` stores): for the pair,
the kernel writes both sources into one (N, H, W, ca+cb) buffer, viewed
packed; for the single and grouped warps the plain output is already the
packed bytes, and the wrapper views it.  On the CPU: the plain warp and a
view, the JAX package's non-TPU path (`warp_pallas.py:1245-1261`).

The flows (and the mask) are taken as float32, as the Pallas wrappers cast
them (`warp_pallas.py:1271,1362-1364`); a bf16 source stays bf16.

Each wrapper counts its kernel launches in `<wrapper>.launches`, and the
packed stores among them also in `<wrapper>.packed_launches`, so a run can
show that the model path went through the kernels.

H-strips.  While `ops.spatial_ctx` is active the three warps route through
the halo-exchange wrappers of `parallel/spatial.py`, as the JAX package's
`flow_warp_auto` / `grouped_warp_auto` do (`warp_pallas.py:1243-1260,
1342-1355`): each rank launches the kernel on its neighbour-padded strip,
or, past the halo, on the gathered frame; `packed_out` packs after the
sharded warp.

Gradients.  On the GPU the warps are `torch.autograd.Function`s whose
backward launches the hand-written kernels of `csrc/warp_grad.cu`
(`flow_warp_backward`, `grouped_warp_backward`, each counting its own
launches): they compute what `jax.grad` of the JAX package's XLA warp
formulas computes, which is how its train step differentiates the warps
(`warp_pallas.py` `set_warp_differentiable`).  A source or flow that needs
no gradient gets none computed (`ctx.needs_input_grad`).  The packed stores
take no gradient (training never packs): under grad they raise.  On the
CPU the plain versions are differentiated by autograd itself, and
`flow_warp_backward_plain` / `grouped_warp_backward_plain` are that
autograd, which the kernels are held to.

Reproducible training.  The backward kernels sum each source pixel's
gradient with atomics, so by default two launches may differ in the last
bits.  Under `torch.use_deterministic_algorithms(True)` both launch
their fixed-order variant
(`lssvc_*_backward_fixed`): the source gradient summed in 64-bit fixed
point with integer atomics, the same bits in any order, counted on
`<wrapper>.fixed_launches` as well.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from . import spatial_ctx
from .packed import pack_width
from .warp import flow_warp as flow_warp_plain
from .warp import grouped_warp_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_GRAD_LIB = None


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
        lib.lssvc_flow_warp_pair_packed.argtypes = [vp, vp, vp, vp, i64, i32,
                                                    i32, i32, i32, i32, vp]
        lib.lssvc_flow_warp_pair_packed.restype = i32
        lib.lssvc_grouped_warp.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32,
                                           i32, i32, i32, i32, vp]
        lib.lssvc_grouped_warp.restype = i32
        _LIB = lib
    return _LIB


def _grad_lib():
    global _GRAD_LIB
    if _GRAD_LIB is None:
        lib = build.load("warp_grad")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.lssvc_flow_warp_backward.argtypes = [vp, vp, vp, i32, vp, vp, vp,
                                                 i32, vp, vp, i64, i32, i32,
                                                 i32, vp]
        lib.lssvc_flow_warp_backward.restype = i32
        lib.lssvc_grouped_warp_backward.argtypes = [vp, vp, vp, vp, vp, vp,
                                                    vp, vp, vp, i64, i32, i32,
                                                    i32, i32, i32, i32, vp]
        lib.lssvc_grouped_warp_backward.restype = i32
        lib.lssvc_f32_to_bf16.argtypes = [vp, vp, i64, vp]
        lib.lssvc_f32_to_bf16.restype = i32
        lib.lssvc_flow_warp_backward_fixed.argtypes = [
            vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp,
            i64, i32, i32, i32, vp]
        lib.lssvc_flow_warp_backward_fixed.restype = i32
        lib.lssvc_grouped_warp_backward_fixed.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
            i32, i32, i32, i32, vp]
        lib.lssvc_grouped_warp_backward_fixed.restype = i32
        _GRAD_LIB = lib
    return _GRAD_LIB


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


def _check_even(w):
    # the packed layout pairs columns (`warp_pallas.py:808-809`)
    if w % 2:
        raise ValueError(f"packed_out needs an even width, got {w}")


def _f32(t):
    return t.float().contiguous()


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _refuse_grad(*ts):
    """A packed store takes no gradient (training warps unpacked, as the JAX
    package trains)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("packed_out warps take no gradient: call the "
                           "warp unpacked under autograd")


def _launch_flow_warp(a, b, flow):
    """The forward kernel: contiguous a (N, H, W, ca) and, unless None, b
    (N, H, W, cb) of a's dtype, warped by the f32 flow; one launch."""
    n, h, w, ca = a.shape
    _check("a", a, (n, h, w, ca), _DTYPES, a.device)
    _check("flow", flow, (n, h, w, 2), (torch.float32,), a.device)
    _check_grid(n, h)
    if b is None:
        out = torch.empty_like(a)
        err = _lib().lssvc_flow_warp(
            a.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, ca,
            _DTYPES[a.dtype], _stream(a))
        _raise_on(err, "flow_warp")
        flow_warp.launches += 1
        return out
    cb = b.shape[-1]
    _check("b", b, (n, h, w, cb), (a.dtype,), a.device)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    err = _lib().lssvc_flow_warp_pair(
        a.data_ptr(), b.data_ptr(), flow.data_ptr(), out_a.data_ptr(),
        out_b.data_ptr(), n, h, w, ca, cb, _DTYPES[a.dtype], _stream(a))
    _raise_on(err, "flow_warp_pair")
    flow_warp.launches += 1
    return out_a, out_b


class _FlowWarp(torch.autograd.Function):
    """`flow_warp` (b None) or `flow_warp_pair` on the GPU, differentiable:
    its backward is one `flow_warp_backward` launch."""

    @staticmethod
    def forward(ctx, flow, a, b):
        ctx.save_for_backward(flow, a, b)
        return _launch_flow_warp(a, b, flow)

    @staticmethod
    def backward(ctx, grad_a, grad_b=None):
        flow, a, b = ctx.saved_tensors
        need_flow, need_a, need_b = ctx.needs_input_grad
        return flow_warp_backward(flow, a, grad_a, b, grad_b, need_a=need_a,
                                  need_b=need_b, need_flow=need_flow)


def flow_warp(x, flow, packed_out=False):
    """Bilinear backward warp (border clamp, align_corners=True).

    x: (N, H, W, C) float32 or bfloat16; flow: (N, H, W, 2) pixel (dx, dy),
    taken as float32.  Output in x's dtype, computed in float32; packed
    (N, H, W/2, 2C) with `packed_out`."""
    if packed_out:
        _check_even(x.shape[2])
        _refuse_grad(x, flow)
    if spatial_ctx.active():
        from ..parallel.spatial import flow_warp_sharded_auto

        out = flow_warp_sharded_auto(x, flow, spatial_ctx.GROUP,
                                     spatial_ctx.HALO)
        return pack_width(out, 2) if packed_out else out
    if x.device.type == "cpu":
        out = flow_warp_plain(x, flow)
        return pack_width(out, 2) if packed_out else out
    out = _FlowWarp.apply(_f32(flow), x.contiguous(), None)
    if packed_out:
        flow_warp.packed_launches += 1
        return pack_width(out, 2)
    return out


flow_warp.launches = 0
flow_warp.packed_launches = 0


def flow_warp_pair(a, b, flow, packed_out=False):
    """Warp two tensors of one dtype by the same flow: on the GPU one
    `flow_warp` launch into two outputs (counted on `flow_warp.launches`);
    on the CPU concat, plain warp, split, which equals two warps bit for bit
    because warping is exact per channel.

    With `packed_out`, one (N, H, W/2, 2(ca+cb)) tensor: the width-packed
    warp of concat([a, b]) (the JAX package's `flow_warp_auto(concat([a,
    b]), packed_out=True)`, `models/lssvc.py:168-172`), which the kernel
    stores with no concat of its sources."""
    if packed_out:
        _check_even(a.shape[2])
        _refuse_grad(a, b, flow)
    if spatial_ctx.active():
        from ..parallel.spatial import flow_warp_pair_sharded_auto

        out = flow_warp_pair_sharded_auto(a, b, flow, spatial_ctx.GROUP,
                                          spatial_ctx.HALO)
        return pack_width(torch.cat(out, dim=-1), 2) if packed_out else out
    if a.device.type == "cpu":
        ca = a.shape[-1]
        out = flow_warp_plain(torch.cat([a, b], dim=-1), flow)
        if packed_out:
            return pack_width(out, 2)
        return out[..., :ca], out[..., ca:]
    if not packed_out:
        return _FlowWarp.apply(_f32(flow), a.contiguous(), b.contiguous())
    n, h, w, ca = a.shape
    cb = b.shape[-1]
    a, b, flow = a.contiguous(), b.contiguous(), _f32(flow)
    _check("a", a, (n, h, w, ca), _DTYPES, a.device)
    _check("b", b, (n, h, w, cb), (a.dtype,), a.device)
    _check("flow", flow, (n, h, w, 2), (torch.float32,), a.device)
    _check_grid(n, h)
    out = torch.empty((n, h, w, ca + cb), dtype=a.dtype, device=a.device)
    err = _lib().lssvc_flow_warp_pair_packed(
        a.data_ptr(), b.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h,
        w, ca, cb, _DTYPES[a.dtype], _stream(a))
    _raise_on(err, "flow_warp_pair_packed")
    flow_warp.launches += 1
    flow_warp.packed_launches += 1
    return pack_width(out, 2)


def _launch_grouped_warp(x, flow_x, flow_y, mask, group_num):
    n, h, w, c_src = x.shape
    go = flow_x.shape[-1]
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


class _GroupedWarp(torch.autograd.Function):
    """`grouped_warp` on the GPU, differentiable: its backward is one
    `grouped_warp_backward` launch."""

    @staticmethod
    def forward(ctx, x, flow_x, flow_y, mask, group_num):
        ctx.save_for_backward(x, flow_x, flow_y, mask)
        ctx.group_num = group_num
        return _launch_grouped_warp(x, flow_x, flow_y, mask, group_num)

    @staticmethod
    def backward(ctx, grad):
        x, flow_x, flow_y, mask = ctx.saved_tensors
        grads = grouped_warp_backward(x, flow_x, flow_y, mask, ctx.group_num,
                                      grad, need=ctx.needs_input_grad[:4])
        return (*grads, None)


def grouped_warp(x, flow_x, flow_y, mask, group_num: int, packed_out=False):
    """OffsetDiversity grouped warp with mask, block-layout output.

    x: (N, H, W, C_src) float32 or bfloat16; flow_x, flow_y, mask:
    (N, H, W, go), taken as float32.  Output (N, H, W, go*cg) in x's dtype,
    channel c' = k*go + j = mask_j * (source channel (j % group_num)*cg + k
    warped by unit j's flow); packed (N, H, W/2, 2*go*cg) with
    `packed_out`."""
    if packed_out:
        _check_even(x.shape[2])
        _refuse_grad(x, flow_x, flow_y, mask)
    if spatial_ctx.active():
        from ..parallel.spatial import grouped_warp_sharded_auto

        out = grouped_warp_sharded_auto(x, flow_x, flow_y, mask, group_num,
                                        spatial_ctx.GROUP,
                                        spatial_ctx.HALO_GROUPED)
        return pack_width(out, 2) if packed_out else out
    if x.device.type == "cpu":
        out = grouped_warp_plain(x, flow_x, flow_y, mask, group_num)
        return pack_width(out, 2) if packed_out else out
    c_src, go = x.shape[-1], flow_x.shape[-1]
    if c_src % group_num or go % group_num:
        raise ValueError(f"C_src={c_src} and go={go} must be multiples of "
                         f"group_num={group_num}")
    out = _GroupedWarp.apply(x.contiguous(), _f32(flow_x), _f32(flow_y),
                             _f32(mask), group_num)
    if packed_out:
        grouped_warp.packed_launches += 1
        return pack_width(out, 2)
    return out


grouped_warp.launches = 0
grouped_warp.packed_launches = 0


# ---------------------------------------------------------------------------
# The backward kernels and their plain versions

class _FixedSums:
    """The fixed-order variant's buffers of one source's gradient: zeroed
    int64 fixed-point sums and f32 non-finite sums, and the gradient in
    the source's dtype (an f32 gradient is written over its non-finite
    sums)."""

    def __init__(self, like):
        self.q = torch.zeros(like.shape, dtype=torch.int64,
                             device=like.device)
        self.nf = torch.zeros(like.shape, dtype=torch.float32,
                              device=like.device)
        self.out = self.nf if like.dtype == torch.float32 else \
            torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _fixed(like, need):
    return _FixedSums(like) if need else None


def _fixed_ptrs(f):
    return (0, 0, 0) if f is None else (f.q.data_ptr(), f.nf.data_ptr(),
                                        f.out.data_ptr())


def _source_grad(acc, like):
    """A source's gradient from its f32 accumulator, in the source's dtype:
    a bf16 source's is rounded once by the kernel library."""
    if acc is None or like.dtype == torch.float32:
        return acc
    out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    _raise_on(_grad_lib().lssvc_f32_to_bf16(acc.data_ptr(), out.data_ptr(),
                                            acc.numel(), _stream(acc)),
              "f32_to_bf16")
    return out


def flow_warp_backward(flow, a, grad_a, b=None, grad_b=None, need_a=True,
                       need_b=True, need_flow=True):
    """The gradient of `flow_warp(a, flow)` (b None) or of
    `flow_warp_pair(a, b, flow)`: (grad_flow, grad_a, grad_b), each None
    where `need_*` is False (grad_b None without b).

    flow (N, H, W, 2) f32; a, b (N, H, W, c) f32 or bf16; grad_a, grad_b
    the outputs' gradients.  On the GPU one launch of
    `lssvc_flow_warp_backward` (counted on `flow_warp_backward.launches`):
    the sources' gradients summed in f32 (direct vector reductions of a
    thread's tap columns) and returned in their dtype, the flow's in f32,
    summed over both sources' channels.  Under
    `torch.use_deterministic_algorithms(True)` it launches
    `lssvc_flow_warp_backward_fixed` instead where a source takes a
    gradient, whose source gradients are the same bits every launch (also
    counted on `flow_warp_backward.fixed_launches`).  On the CPU
    `flow_warp_backward_plain`."""
    if a.device.type == "cpu":
        gf, ga, gb = flow_warp_backward_plain(flow, a, grad_a, b, grad_b)
        return (gf if need_flow else None, ga if need_a else None,
                gb if b is not None and need_b else None)
    n, h, w, ca = a.shape
    _check_grid(n, h)
    a, flow = a.contiguous(), flow.contiguous()
    _check("a", a, (n, h, w, ca), _DTYPES, a.device)
    _check("flow", flow, (n, h, w, 2), (torch.float32,), a.device)
    grad_a = grad_a.to(a.dtype).contiguous()
    _check("grad_a", grad_a, (n, h, w, ca), (a.dtype,), a.device)
    cb = 0
    if b is not None:
        cb = b.shape[-1]
        b = b.contiguous()
        grad_b = grad_b.to(b.dtype).contiguous()
        _check("b", b, (n, h, w, cb), (a.dtype,), a.device)
        _check("grad_b", grad_b, (n, h, w, cb), (a.dtype,), a.device)
    need_b = need_b and b is not None
    gflow = torch.empty((n, h, w, 2), dtype=torch.float32,
                        device=a.device) if need_flow else None
    if torch.are_deterministic_algorithms_enabled() and (need_a or need_b):
        fa, fb = _fixed(a, need_a), _fixed(b, need_b)
        mx = torch.zeros(1, dtype=torch.int32, device=a.device)
        err = _grad_lib().lssvc_flow_warp_backward_fixed(
            a.data_ptr(), grad_a.data_ptr(), *_fixed_ptrs(fa), ca, _ptr(b),
            _ptr(grad_b), *_fixed_ptrs(fb), cb, flow.data_ptr(),
            _ptr(gflow), mx.data_ptr(), n, h, w, _DTYPES[a.dtype],
            _stream(a))
        _raise_on(err, "flow_warp_backward_fixed")
        flow_warp_backward.launches += 1
        flow_warp_backward.fixed_launches += 1
        return (gflow, None if fa is None else fa.out,
                None if fb is None else fb.out)

    def acc(t, need):
        return torch.zeros(t.shape, dtype=torch.float32,
                           device=t.device) if need else None

    acc_a, acc_b = acc(a, need_a), acc(b, need_b)
    err = _grad_lib().lssvc_flow_warp_backward(
        a.data_ptr(), grad_a.data_ptr(), _ptr(acc_a), ca, _ptr(b),
        _ptr(grad_b), _ptr(acc_b), cb, flow.data_ptr(), _ptr(gflow), n, h, w,
        _DTYPES[a.dtype], _stream(a))
    _raise_on(err, "flow_warp_backward")
    flow_warp_backward.launches += 1
    return gflow, _source_grad(acc_a, a), _source_grad(acc_b, b)


flow_warp_backward.launches = 0
flow_warp_backward.fixed_launches = 0


def flow_warp_backward_plain(flow, a, grad_a, b=None, grad_b=None):
    """`flow_warp_backward` by autograd through the plain warp (the pair as
    one warp of concat([a, b])): (grad_flow, grad_a, grad_b)."""
    with torch.enable_grad():
        fl = flow.detach().float().requires_grad_()
        srcs = [a.detach().requires_grad_()]
        grads = [grad_a]
        if b is not None:
            srcs.append(b.detach().requires_grad_())
            grads.append(grad_b)
        out = flow_warp_plain(torch.cat(srcs, dim=-1), fl)
        got = torch.autograd.grad(out, [fl, *srcs],
                                  torch.cat(grads, dim=-1).to(out.dtype))
    return got[0], got[1], got[2] if b is not None else None


def grouped_warp_backward(x, flow_x, flow_y, mask, group_num, grad,
                          need=(True, True, True, True)):
    """The gradient of `grouped_warp(x, flow_x, flow_y, mask, group_num)`:
    (grad_x, grad_flow_x, grad_flow_y, grad_mask), each None where `need`
    (for x, flow_x, flow_y, mask) is False.

    On the GPU one launch of `lssvc_grouped_warp_backward` (counted on
    `grouped_warp_backward.launches`): x's gradient summed in f32 over the
    units (each unit's taps over a tile in a shared-memory box flushed with
    vector reductions, or straight to global memory) and returned in x's
    dtype, the flows' and mask's per unit in f32.  Under
    `torch.use_deterministic_algorithms(True)` it launches
    `lssvc_grouped_warp_backward_fixed` instead where x takes a gradient,
    whose x gradient is the same bits every launch (also counted on
    `grouped_warp_backward.fixed_launches`).  The kernel refuses a shape
    whose staged tile passes its shared memory (go * cg past about 1,000
    in f32).  On the CPU `grouped_warp_backward_plain`."""
    if x.device.type == "cpu":
        got = grouped_warp_backward_plain(x, flow_x, flow_y, mask, group_num,
                                          grad)
        return tuple(g if nd else None for g, nd in zip(got, need))
    n, h, w, c_src = x.shape
    _check_grid(n, h)
    go = flow_x.shape[-1]
    cg = c_src // group_num
    x = x.contiguous()
    flow_x, flow_y, mask = (_f32(t) for t in (flow_x, flow_y, mask))
    _check("x", x, (n, h, w, c_src), _DTYPES, x.device)
    for name, t in (("flow_x", flow_x), ("flow_y", flow_y), ("mask", mask)):
        _check(name, t, (n, h, w, go), (torch.float32,), x.device)
    grad = grad.to(x.dtype).contiguous()
    _check("grad", grad, (n, h, w, go * cg), (x.dtype,), x.device)
    need_x, need_fx, need_fy, need_m = need

    def unit_grad(nd):
        return torch.empty((n, h, w, go), dtype=torch.float32,
                           device=x.device) if nd else None

    gfx, gfy, gm = unit_grad(need_fx), unit_grad(need_fy), unit_grad(need_m)
    if torch.are_deterministic_algorithms_enabled() and need_x:
        fx_ = _FixedSums(x)
        mx = torch.zeros(2, dtype=torch.int32, device=x.device)
        err = _grad_lib().lssvc_grouped_warp_backward_fixed(
            x.data_ptr(), grad.data_ptr(), flow_x.data_ptr(),
            flow_y.data_ptr(), mask.data_ptr(), *_fixed_ptrs(fx_), _ptr(gfx),
            _ptr(gfy), _ptr(gm), mx.data_ptr(), n, h, w, c_src, go,
            group_num, _DTYPES[x.dtype], _stream(x))
        _raise_on(err, "grouped_warp_backward_fixed")
        grouped_warp_backward.launches += 1
        grouped_warp_backward.fixed_launches += 1
        return fx_.out, gfx, gfy, gm
    acc_x = torch.zeros(x.shape, dtype=torch.float32,
                        device=x.device) if need_x else None
    err = _grad_lib().lssvc_grouped_warp_backward(
        x.data_ptr(), grad.data_ptr(), flow_x.data_ptr(), flow_y.data_ptr(),
        mask.data_ptr(), _ptr(acc_x), _ptr(gfx), _ptr(gfy), _ptr(gm), n, h, w,
        c_src, go, group_num, _DTYPES[x.dtype], _stream(x))
    _raise_on(err, "grouped_warp_backward")
    grouped_warp_backward.launches += 1
    return _source_grad(acc_x, x), gfx, gfy, gm


grouped_warp_backward.launches = 0
grouped_warp_backward.fixed_launches = 0


def grouped_warp_backward_plain(x, flow_x, flow_y, mask, group_num, grad):
    """`grouped_warp_backward` by autograd through `grouped_warp_plain`:
    (grad_x, grad_flow_x, grad_flow_y, grad_mask)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (x, flow_x.float(), flow_y.float(), mask.float())]
        out = grouped_warp_plain(*ins, group_num)
        return torch.autograd.grad(out, ins, grad.to(out.dtype))
