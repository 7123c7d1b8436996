"""Every variant of the JAX package's warp tier bench, through the port, on
the GPU.

    python -m lssvc_tpu_torch.tools.warp_tier_bench [variant ...]

The twin of `tools/warp_tier_bench.py`, at its shapes: x 1x1152x1920x48,
single flows uniform in +-0.4 px (+-20 px for `single_cblock_27`), and 32
OffsetDiversity units (16 groups x 2 offsets) with offsets in +-0.4 px and
masks in [0, 1).  Inputs come from a `torch.Generator` seed (`SEED`).

The TPU needed its warp tiers because a gather there is a scalar loop and a
VMEM window bounds how far a sample may move.  On the GPU one gather kernel
is exact for every flow magnitude, so the tiers collapse: each variant name
maps to the port call that computes what its Pallas kernel computed, and
the tier's bound |flow| <= b, a precondition the gather kernel does not
need, has no counterpart.  The map (`VARIANTS`):

  grouped_pallas_43   _grouped_warp_kernel (d_v=43)        -> grouped_warp
  grouped_pallas_3    _grouped_warp_kernel (d_v=3)         -> grouped_warp
  grouped_cblock      _grouped_warp_kernel_cblock (b=2)    -> grouped_warp
  grouped_smallflow   _grouped_warp_kernel_smallflow (b=2) -> grouped_warp
                      on x.float(): that kernel's output is always f32
  grouped_shift_sum   XLA tap sum (b=2)  -> ops.warp.grouped_warp_shift_sum
  single_pallas_27    _warp_kernel (d_v=27)                -> flow_warp
  single_pallas_3     _warp_kernel (d_v=3)                 -> flow_warp
  single_cblock       _warp_kernel_cblock (b=2); with LSSVC_WARP_ROLL=1
                      _warp_kernel_cblock_roll, with LSSVC_WARP_WIDE=1
                      _warp_kernel_cblock_wide             -> flow_warp
  single_cblock_27    _warp_kernel_cblock (b=27), +-20 px  -> flow_warp
  single_smallflow    _warp_kernel_smallflow (b=2)         -> flow_warp
                      on x.float(): that kernel's output is always f32
  single_shift_sum    XLA tap sum (b=2)  -> ops.warp.flow_warp_shift_sum

Each variant is held against the plain gather version (`ops/warp.py`
`flow_warp` / `grouped_warp_plain`) and timed with CUDA events; one JSON
line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, NamedTuple

import torch

from ..ops import warp as plain_warp
from ..ops import warp_kernels as wk
from .timing import card, require_cuda, time_ms

H, W, C = 1152, 1920, 48
UNITS, GROUPS = 32, 16
SMALL, BOUND = 0.4, 2       # the bench's flow range and its tap-sum bound
WIDE = 20.0                 # flow range of single_cblock_27
ITERS = 20                  # timed calls of a gather variant (3 of a shift sum)
SEED = 0


class Variant(NamedTuple):
    kernel: str | None      # the kernel it launches; None for a plain tap sum
    fn: Callable            # the bench's tensors -> the warped output
    stands_for: str         # what the JAX variant ran


def _grouped(x, inp):
    return wk.grouped_warp(x, inp["fx"], inp["fy"], inp["mask"], GROUPS)


_WP = "lssvc_tpu/ops/warp_pallas.py"
VARIANTS = {
    "grouped_pallas_43": Variant(
        "grouped_warp", lambda i: _grouped(i["x"], i),
        f"{_WP}:892 _grouped_warp_kernel, d_v=43"),
    "grouped_pallas_3": Variant(
        "grouped_warp", lambda i: _grouped(i["x"], i),
        f"{_WP}:892 _grouped_warp_kernel, d_v=3"),
    "grouped_cblock": Variant(
        "grouped_warp", lambda i: _grouped(i["x"], i),
        f"{_WP}:647 _grouped_warp_kernel_cblock, b=2"),
    "grouped_smallflow": Variant(
        "grouped_warp", lambda i: _grouped(i["x"].float(), i),
        f"{_WP}:859 _grouped_warp_kernel_smallflow, b=2"),
    "grouped_shift_sum": Variant(
        None, lambda i: plain_warp.grouped_warp_shift_sum(
            i["x"], i["fx"], i["fy"], i["mask"], GROUPS, BOUND),
        "lssvc_tpu/ops/warp.py:362 grouped_warp_shift_sum"),
    "single_pallas_27": Variant(
        "flow_warp", lambda i: wk.flow_warp(i["x"], i["flow"]),
        f"{_WP}:151 _warp_kernel, d_v=27"),
    "single_pallas_3": Variant(
        "flow_warp", lambda i: wk.flow_warp(i["x"], i["flow"]),
        f"{_WP}:151 _warp_kernel, d_v=3"),
    "single_cblock": Variant(
        "flow_warp", lambda i: wk.flow_warp(i["x"], i["flow"]),
        f"{_WP}:305 _warp_kernel_cblock, b=2 (:477 _warp_kernel_cblock_roll "
        "with LSSVC_WARP_ROLL=1, :407 _warp_kernel_cblock_wide with "
        "LSSVC_WARP_WIDE=1)"),
    "single_cblock_27": Variant(
        "flow_warp", lambda i: wk.flow_warp(i["x"], i["flow27"]),
        f"{_WP}:305 _warp_kernel_cblock, b=27"),
    "single_smallflow": Variant(
        "flow_warp", lambda i: wk.flow_warp(i["x"].float(), i["flow"]),
        f"{_WP}:232 _warp_kernel_smallflow, b=2"),
    "single_shift_sum": Variant(
        None, lambda i: plain_warp.flow_warp_shift_sum(i["x"], i["flow"],
                                                       BOUND),
        "lssvc_tpu/ops/warp.py:320 flow_warp_shift_sum"),
}


def make_inputs(device="cuda", h=H, w=W):
    """The bench's tensors, from one generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(SEED)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    return {"x": uni((1, h, w, C), 0, 1),
            "fx": uni((1, h, w, UNITS), -SMALL, SMALL),
            "fy": uni((1, h, w, UNITS), -SMALL, SMALL),
            "mask": uni((1, h, w, UNITS), 0, 1),
            "flow": uni((1, h, w, 2), -SMALL, SMALL),
            "flow27": uni((1, h, w, 2), -WIDE, WIDE)}


def call(name, inp):
    """Run variant `name` through the port."""
    return VARIANTS[name].fn(inp)


def plain(name, inp):
    """The plain gather version of what variant `name` computes."""
    if name.startswith("grouped"):
        return plain_warp.grouped_warp_plain(
            inp["x"].float(), inp["fx"], inp["fy"], inp["mask"], GROUPS)
    flow = inp["flow27" if name == "single_cblock_27" else "flow"]
    return plain_warp.flow_warp(inp["x"].float(), flow)


def _max_abs_err(name, out, ref, x):
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    return float((out.float() - ref.float()).abs().max())


def run(inp, names=None, check=_max_abs_err):
    """Each variant once against its plain version (`check(name, out, ref,
    x)` returns the error or raises), then timed; one row per variant with
    the launches of its first call."""
    rows = []
    for name in names or VARIANTS:
        v = VARIANTS[name]
        n0 = (wk.flow_warp.launches, wk.grouped_warp.launches)
        out = v.fn(inp)
        launches = {"flow_warp": wk.flow_warp.launches - n0[0],
                    "grouped_warp": wk.grouped_warp.launches - n0[1]}
        err = check(name, out, plain(name, inp), inp["x"])
        del out
        rows.append({"name": name, "kernel": v.kernel,
                     "stands_for": v.stands_for, "max_abs_err": err,
                     "launches_per_call": launches,
                     "ms": time_ms(lambda: v.fn(inp),
                                   ITERS if v.kernel else 3, 1)})
    return rows


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: {sorted(VARIANTS)}")
    dev = require_cuda()
    for row in run(make_inputs(dev), names):
        print(json.dumps(row), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
