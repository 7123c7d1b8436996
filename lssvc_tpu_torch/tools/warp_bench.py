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
"""

from __future__ import annotations

import inspect
import json

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


def main():
    dev = require_cuda()
    result = run(dev)
    if "packed_out" in inspect.signature(wk.flow_warp_pair).parameters:
        result["packed"] = packed_run(dev)
    print(json.dumps(result), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
