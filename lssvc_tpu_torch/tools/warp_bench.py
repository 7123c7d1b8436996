"""The port's warps timed at the shapes of one 1080p two-layer P-frame, on
the GPU.

    python -m lssvc_tpu_torch.tools.warp_bench

`FRAME` lists the warp calls one P-frame makes (EL 1152x1920, BL 576x960):
per layer, four SpyNet levels on RGB, the reference frame and the
full-resolution feature warped by one flow as a pair, and the two smaller
feature scales; then OffsetDiversity's one grouped warp (`GROUPED`).  Each
call is timed as a whole (CUDA events, inputs uniform in [-1, 1), smooth
flows of amplitude `TIME_FLOW_PX`), beside its byte bound; the EL pair and
the grouped warp again on random per-pixel flows.  Then (`packed_run`) the
EL pair and the grouped warp in f32 and bf16, each in the plain layout and
through its width-packed store (`packed_out=True`: the pair as the fused
packed pair warp of `LSSVC_PACKED_CTX`, the grouped warp as the
`grouped_packed_out` case of the JAX package's
`tools/warp_overhead_bench.py:150-168`), beside their byte bounds.  One
JSON line, then the card's name and power limit.

The tool uses only the wrappers' public calls (`flow_warp`,
`flow_warp_pair`, `grouped_warp`), so it also times an older tree of the
package in the same way:

    PYTHONPATH=<older tree> python lssvc_tpu_torch/tools/warp_bench.py

(a tree whose wrappers take no `packed_out` skips `packed_run`).

    python -m lssvc_tpu_torch.tools.warp_bench --backward [--kernel-only]

times the warps' backward kernels instead (`backward_run`): the gradient
of the 1080p EL pair (`wk.flow_warp_backward`) and of OffsetDiversity's
grouped warp (`wk.grouped_warp_backward`), each also at the training crop
256, f32 and bf16, on smooth flows (`smooth_field` at 12 px; for the
grouped warp also a shared 12 px field plus per-unit smooth offsets of
40 px, the trainer's uncapped range) and random flows (+-6 px a pixel).
Each is timed as the wrapper's call (as the trainer pays it) and as the
kernel alone (its C entry point called back to back on preallocated
buffers, free of the wrapper's allocations, rounding pass and host work,
which pace the calls at the crop), both with CUDA events.  Beside each:
its byte bound (the output gradient,
the source and the flows and mask read once, their gradients written
once), the zero-fill and bf16 rounding passes the wrapper runs around
the kernel, the fixed-order variant that
`torch.use_deterministic_algorithms(True)` selects (its wrapper call and
its C entry point, where the tree has one), and unless
`--kernel-only` the plain autograd's backward and, for the pair,
`F.grid_sample`'s backward.  It calls only the two public wrappers, so

    PYTHONPATH=<older tree> python lssvc_tpu_torch/tools/warp_bench.py \
        --backward --kernel-only

times an older tree's kernels in the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os

import torch
import torch.nn.functional as F

from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.tools.timing import card, require_cuda, time_ms

# H100 SXM peaks from NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TIME_FLOW_PX = 12.0  # flow amplitude of the timed calls: motion + OD offset
SEED = 0

# (call, shape): flow_warp (n, h, w, c); flow_warp_pair (n, h, w, ca, cb)
FRAME = [
    ("flow_warp", (1, 72, 120, 3)), ("flow_warp", (1, 144, 240, 3)),
    ("flow_warp", (1, 288, 480, 3)), ("flow_warp", (1, 576, 960, 3)),
    ("flow_warp_pair", (1, 576, 960, 3, 64)),
    ("flow_warp", (1, 288, 480, 64)), ("flow_warp", (1, 144, 240, 64)),
    ("flow_warp", (1, 144, 240, 3)), ("flow_warp", (1, 288, 480, 3)),
    ("flow_warp", (1, 576, 960, 3)), ("flow_warp", (1, 1152, 1920, 3)),
    ("flow_warp_pair", (1, 1152, 1920, 3, 48)),
    ("flow_warp", (1, 576, 960, 64)), ("flow_warp", (1, 288, 480, 96)),
]
EL_PAIR = FRAME[11][1]
GROUPED = (1, 1152, 1920, 48, 32, 16)  # (n, h, w, c_src, go, group_num)


def uniform(gen, shape, lo, hi):
    """Uniform [lo, hi) float32 tensor on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def smooth_field(gen, shape, amp):
    """An NHWC field with |value| <= amp that varies over ~32 pixels, the
    way a codec's motion does."""
    n, h, w, c = shape
    cell = 32
    coarse = uniform(gen, (n, c, h // cell + 2, w // cell + 2), -amp, amp)
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).contiguous()


def bound_ms(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """The least time for moving `nbytes` and doing `flops`, and which of
    the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flow_warp_cost(n, h, w, c, elt):
    """Bytes: x read once, flow read once, output written once.  Operations:
    11 per output element (the lerp) + 10 per pixel (the coordinates)."""
    return (n * h * w * (2 * c * elt + 8),
            n * h * w * (11 * c + 10))


def grouped_cost(n, h, w, c_src, go, group_num, elt):
    """Bytes: x read once, flow_x, flow_y and mask read once, the go*cg
    output channels written once.  Operations: 12 per output element + 10
    per (pixel, unit)."""
    cg = c_src // group_num
    return (n * h * w * (c_src * elt + 3 * go * 4 + go * cg * elt),
            n * h * w * go * (12 * cg + 10))


def flow_call(name, shape, elt=4):
    """The wrapper of a FRAME call and its byte bound."""
    n, h, w = shape[:3]
    fn = wk.flow_warp if name == "flow_warp" else wk.flow_warp_pair
    return fn, bound_ms(*flow_warp_cost(n, h, w, sum(shape[3:]), elt))


def flow_inputs(gen, shape, smooth=True, dtype=torch.float32):
    """The tensors of a FRAME call (x, or a and b) and a flow."""
    n, h, w = shape[:3]
    xs = [uniform(gen, (n, h, w, c), -1, 1).to(dtype) for c in shape[3:]]
    flow = (smooth_field(gen, (n, h, w, 2), TIME_FLOW_PX) if smooth
            else uniform(gen, (n, h, w, 2), -TIME_FLOW_PX, TIME_FLOW_PX))
    return xs, flow


def grouped_inputs(gen, smooth=True, dtype=torch.float32):
    """x, flow_x, flow_y, mask of OffsetDiversity's launch."""
    n, h, w, c_src, go, _ = GROUPED
    units = (n, h, w, go)
    fx, fy = ((smooth_field(gen, units, TIME_FLOW_PX) if smooth
               else uniform(gen, units, -TIME_FLOW_PX, TIME_FLOW_PX))
              for _ in range(2))
    return (uniform(gen, (n, h, w, c_src), -1, 1).to(dtype), fx, fy,
            uniform(gen, units, 0, 1))


def packed_run(dev):
    """The EL pair and the grouped warp at the model's shapes, f32 and
    bf16, plain layout and packed store: {dtype: {"pair_ms",
    "pair_packed_ms", "pair_bound_ms", "grouped_ms", "grouped_packed_ms",
    "grouped_bound_ms"}}.  A packed store moves the same bytes as the
    plain layout, so it has the same bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, h, w, ca, cb = EL_PAIR
    gn = GROUPED[-1]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.finfo(dtype).bits // 8
        xs, flow = flow_inputs(gen, EL_PAIR, dtype=dtype)
        x, fx, fy, m = grouped_inputs(gen, dtype=dtype)
        out[str(dtype)[6:]] = {
            "pair_ms": time_ms(lambda: wk.flow_warp_pair(*xs, flow)),
            "pair_packed_ms": time_ms(
                lambda: wk.flow_warp_pair(*xs, flow, packed_out=True)),
            "pair_bound_ms": bound_ms(*flow_warp_cost(n, h, w, ca + cb,
                                                      elt))[0],
            "grouped_ms": time_ms(lambda: wk.grouped_warp(x, fx, fy, m, gn)),
            "grouped_packed_ms": time_ms(
                lambda: wk.grouped_warp(x, fx, fy, m, gn, packed_out=True)),
            "grouped_bound_ms": bound_ms(*grouped_cost(*GROUPED, elt))[0],
        }
        del xs, flow, x, fx, fy, m
    return out


def run(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frame = []
    for name, shape in FRAME:
        (fn, (b_ms, _)), (xs, flow) = flow_call(name, shape), \
            flow_inputs(gen, shape)
        frame.append({"call": name, "shape": list(shape),
                      "ms": time_ms(lambda: fn(*xs, flow)), "bound_ms": b_ms})
    del xs, flow
    xs, flow = flow_inputs(gen, EL_PAIR, smooth=False)
    pair_random = time_ms(lambda: wk.flow_warp_pair(*xs, flow))
    del xs, flow
    gn = GROUPED[-1]
    grouped = {}
    for label, smooth in (("ms", True), ("ms_random_flows", False)):
        x, fx, fy, m = grouped_inputs(gen, smooth)
        grouped[label] = time_ms(lambda: wk.grouped_warp(x, fx, fy, m, gn))
    del x, fx, fy, m
    grouped["bound_ms"] = bound_ms(*grouped_cost(*GROUPED, 4))[0]
    return {
        "frame": frame,
        "frame_ms": sum(f["ms"] for f in frame),
        "frame_bound_ms": sum(f["bound_ms"] for f in frame),
        "pair_ms": frame[FRAME.index(("flow_warp_pair", EL_PAIR))]["ms"],
        "pair_ms_random_flows": pair_random,
        "grouped": grouped,
    }


# ---------------------------------------------------------------------------
# The backward kernels

CROP = 256  # the training crop
BACKWARD = [("flow_warp_backward", EL_PAIR),
            ("flow_warp_backward", (1, CROP, CROP, 3, 48)),
            ("grouped_warp_backward", GROUPED),
            ("grouped_warp_backward", (1, CROP, CROP, 48, 32, 16))]
BACKWARD_FLOWS = {"flow_warp_backward": ("smooth", "random"),
                  "grouped_warp_backward": ("smooth", "smooth40", "random")}
RANDOM_FLOW_PX = 6.0  # random flows: uniform in +-6 px a pixel
OFFSET_PX = 40.0  # OffsetDiversity's uncapped offsets in training


def grad_cost(kind, shape, elt):
    """Bytes: the output gradient, the source and the flows (and mask) read
    once, the source's and the flows' (and mask's) gradients written once.
    Operations: ~30 per (pixel, channel) of the gradient arithmetic."""
    if kind == "flow_warp_backward":
        n, h, w, ca, cb = shape
        c = ca + cb
        return n * h * w * (3 * c * elt + 16), n * h * w * 30 * c
    n, h, w, c_src, go, gn = shape
    cg = c_src // gn
    return (n * h * w * (2 * c_src * elt + go * cg * elt + 6 * go * 4),
            n * h * w * go * 30 * cg)


def backward_inputs(gen, kind, shape, flows, dtype):
    """Sources, flows (the grouped warp: flow_x, flow_y, mask) and output
    gradients of one backward case."""
    n, h, w = shape[:3]
    if kind == "flow_warp_backward":
        srcs = [uniform(gen, (n, h, w, c), 0, 1).to(dtype)
                for c in shape[3:]]
        flow = (smooth_field(gen, (n, h, w, 2), TIME_FLOW_PX)
                if flows == "smooth" else
                uniform(gen, (n, h, w, 2), -RANDOM_FLOW_PX, RANDOM_FLOW_PX))
        return srcs, flow, [uniform(gen, s.shape, -1, 1).to(dtype)
                            for s in srcs]
    _, _, _, c_src, go, gn = shape
    units = (n, h, w, go)
    if flows == "smooth":
        fx, fy = (smooth_field(gen, units, TIME_FLOW_PX) for _ in range(2))
    elif flows == "smooth40":  # one motion field plus each unit's offset
        base = smooth_field(gen, (n, h, w, 2), TIME_FLOW_PX)
        fx, fy = (base[..., i:i + 1] + smooth_field(gen, units, OFFSET_PX)
                  for i in range(2))
    else:
        fx, fy = (uniform(gen, units, -RANDOM_FLOW_PX, RANDOM_FLOW_PX)
                  for _ in range(2))
    mask = uniform(gen, units, 0, 1)
    grad = uniform(gen, (n, h, w, go * (c_src // gn)), -1, 1).to(dtype)
    return ([uniform(gen, (n, h, w, c_src), 0, 1).to(dtype)],
            (fx.contiguous(), fy.contiguous(), mask), [grad])


def _plain_and_library_ms(kind, shape, srcs, flow, grads):
    """The plain autograd's backward (its graph built once) and, for the
    pair, F.grid_sample's backward (bilinear, border, align_corners: the
    library call's yardstick, which differs from JAX at the clip's
    ties)."""
    from lssvc_tpu_torch.ops import warp as plain

    with torch.enable_grad():
        ins = [s.detach().requires_grad_() for s in srcs]
        if kind == "flow_warp_backward":
            fl = flow.detach().requires_grad_()
            out = plain.flow_warp(torch.cat(ins, -1), fl)
            ins.append(fl)
            g = torch.cat(grads, -1)
        else:
            ins += [t.detach().requires_grad_() for t in flow]
            out = plain.grouped_warp_plain(*ins, shape[5])
            g = grads[0]
        plain_ms = time_ms(lambda: torch.autograd.grad(
            out, ins, g, retain_graph=True), iters=5, warmup=1)
        del out
        if kind != "flow_warp_backward":
            return plain_ms, None
        x = torch.cat(srcs, -1).permute(0, 3, 1, 2).detach() \
            .requires_grad_()
        _, h, w, _ = flow.shape
        iy = torch.arange(h, device=flow.device,
                          dtype=torch.float32)[None, :, None]
        ix = torch.arange(w, device=flow.device,
                          dtype=torch.float32)[None, None, :]
        grid = torch.stack([(ix + flow[..., 0]) / ((w - 1) / 2) - 1,
                            (iy + flow[..., 1]) / ((h - 1) / 2) - 1], -1) \
            .to(x.dtype).requires_grad_()
        lib_out = F.grid_sample(x, grid, mode="bilinear",
                                padding_mode="border", align_corners=True)
        gl = g.permute(0, 3, 1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (x, grid), gl, retain_graph=True), iters=10)
    return plain_ms, library_ms


def kernel_ms(kind, shape, srcs, flow, grads):
    """Device ms of the backward kernel alone: its C entry point
    (`lssvc_flow_warp_backward` / `lssvc_grouped_warp_backward`, whose
    signature every tree of the port shares) called back to back on
    preallocated f32 accumulators and gradients."""
    lib, dev = wk._grad_lib(), srcs[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    dtype = wk._DTYPES[srcs[0].dtype]
    acc = [torch.zeros(s.shape, dtype=torch.float32, device=dev)
           for s in srcs]
    n, h, w = shape[:3]
    if kind == "flow_warp_backward":
        gflow = torch.empty((n, h, w, 2), dtype=torch.float32, device=dev)
        args = (srcs[0].data_ptr(), grads[0].data_ptr(), acc[0].data_ptr(),
                shape[3], srcs[1].data_ptr(), grads[1].data_ptr(),
                acc[1].data_ptr(), shape[4], flow.data_ptr(),
                gflow.data_ptr(), n, h, w, dtype, stream)
        fn = lib.lssvc_flow_warp_backward
    else:
        outs = [torch.empty(flow[0].shape, dtype=torch.float32, device=dev)
                for _ in range(3)]
        args = (srcs[0].data_ptr(), grads[0].data_ptr(),
                *(t.data_ptr() for t in flow), acc[0].data_ptr(),
                *(t.data_ptr() for t in outs), n, h, w, *shape[3:], dtype,
                stream)
        fn = lib.lssvc_grouped_warp_backward
    if fn(*args) != 0:
        raise RuntimeError(f"{kind} {shape}: the kernel launch failed")
    return time_ms(lambda: fn(*args))


# what PyTorch asks of cuBLAS before it runs under the deterministic flag
CUBLAS_DETERMINISTIC = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)` for the block, the flag
    restored after; cuBLAS's workspace setting that the flag needs
    (`CUBLAS_WORKSPACE_CONFIG`, read at each cuBLAS call) set for the block
    where the environment has none."""
    before = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def fixed_kernel_ms(kind, shape, srcs, flow, grads):
    """Device ms of the fixed-order variant's C entry point
    (`lssvc_*_backward_fixed`: the max reduction, the kernel and the
    conversion out of fixed point) back to back on preallocated buffers
    (its sums not zeroed again between calls: the same work)."""
    lib, dev = wk._grad_lib(), srcs[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    dtype = wk._DTYPES[srcs[0].dtype]
    sums = [wk._FixedSums(s) for s in srcs]
    mx = torch.zeros(2, dtype=torch.int32, device=dev)
    n, h, w = shape[:3]
    if kind == "flow_warp_backward":
        gflow = torch.empty((n, h, w, 2), dtype=torch.float32, device=dev)
        args = (srcs[0].data_ptr(), grads[0].data_ptr(),
                *wk._fixed_ptrs(sums[0]), shape[3], srcs[1].data_ptr(),
                grads[1].data_ptr(), *wk._fixed_ptrs(sums[1]), shape[4],
                flow.data_ptr(), gflow.data_ptr(), mx.data_ptr(), n, h, w,
                dtype, stream)
        fn = lib.lssvc_flow_warp_backward_fixed
    else:
        outs = [torch.empty(flow[0].shape, dtype=torch.float32, device=dev)
                for _ in range(3)]
        args = (srcs[0].data_ptr(), grads[0].data_ptr(),
                *(t.data_ptr() for t in flow), *wk._fixed_ptrs(sums[0]),
                *(t.data_ptr() for t in outs), mx.data_ptr(), n, h, w,
                *shape[3:], dtype, stream)
        fn = lib.lssvc_grouped_warp_backward_fixed
    if fn(*args) != 0:
        raise RuntimeError(f"{kind} {shape}: the fixed-order launch failed")
    return time_ms(lambda: fn(*args))


def backward_run(dev, kernel_only=False):
    """Each backward case's ms a wrapper call and ms of the kernel alone
    beside its bound, the wrapper's zero-fill and rounding passes and
    (unless kernel_only) the plain and library backward: a list of
    dicts."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    fixed = hasattr(wk, "_FixedSums")  # a tree with the fixed-order variant
    out = []
    for kind, shape in BACKWARD:
        for dtype in (torch.float32, torch.bfloat16):
            elt = torch.finfo(dtype).bits // 8
            for flows in BACKWARD_FLOWS[kind]:
                srcs, flow, grads = backward_inputs(gen, kind, shape, flows,
                                                    dtype)
                if kind == "flow_warp_backward":
                    def kernel():
                        return wk.flow_warp_backward(flow, srcs[0], grads[0],
                                                     srcs[1], grads[1])
                else:
                    def kernel():
                        return wk.grouped_warp_backward(srcs[0], *flow,
                                                        shape[5], grads[0])

                def outside():
                    # the f32 accumulators the wrapper zeroes and, for
                    # bf16, rounds into the sources' dtype
                    return [wk._source_grad(torch.zeros(
                        s.shape, dtype=torch.float32, device=dev), s)
                        for s in srcs]

                bound, by = bound_ms(*grad_cost(kind, shape, elt))
                row = {"kind": kind, "shape": list(shape),
                       "dtype": str(dtype)[6:], "flows": flows,
                       "ms": time_ms(kernel),
                       "kernel_ms": kernel_ms(kind, shape, srcs, flow,
                                              grads),
                       "bound_ms": bound, "bound_by": by,
                       "outside_ms": time_ms(outside)}
                row["share_of_bound"] = bound / row["kernel_ms"]
                if fixed:
                    with deterministic():
                        row["fixed_ms"] = time_ms(kernel)
                    row["fixed_kernel_ms"] = fixed_kernel_ms(
                        kind, shape, srcs, flow, grads)
                if not kernel_only:
                    row["plain_ms"], row["library_ms"] = \
                        _plain_and_library_ms(kind, shape, srcs, flow, grads)
                out.append(row)
                del srcs, flow, grads
                torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the warps' backward kernels")
    ap.add_argument("--kernel-only", action="store_true",
                    help="with --backward: skip the plain and library "
                         "backward")
    args = ap.parse_args(argv)
    dev = require_cuda()
    if args.backward:
        result = {"backward": backward_run(dev, args.kernel_only)}
    else:
        result = run(dev)
        if "packed_out" in inspect.signature(wk.flow_warp_pair).parameters:
            result["packed"] = packed_run(dev)
    print(json.dumps(result), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
