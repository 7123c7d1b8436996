"""What one latent-RDO iteration costs on the GPU (`models/rdo.py`).

    python -m lssvc_tpu_torch.tools.rdo_bench [--iters 6] [--hw 576x960]
        [--modes fp32 bf16]

IntraNoAR at N=192 from the port's random init codes the BL of a 1080p
frame at x2 (576x960 padded; uniform noise from seed 0) in each precision.
An iteration is what `bits_rdo` does once: the RD loss and its gradients
in y and z (autograd), the two masked updates and the loss's one sync.
Per precision: ms per iteration from `bits_rdo`'s own trace (host clock
between the iterations' syncs, the first iteration left out) over
`--iters` iterations, then one more iteration with CUDA events around it
and its forward convolutions (`profile_frame.conv_spans`), its FLOPs
counted from its shapes, and one under torch.profiler: the device time
of its kernels, the top kernels, and the convolution ops (forward and
backward) by input shape and device time.  One JSON line per precision,
with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..models import IntraNoAR
from ..models import rdo
from ..models.init import init_intra_noar
from .profile_frame import _device_us, conv_spans, frame_flops
from .timing import card, require_cuda

TOP = 12


def _op_device_us(evt):
    return getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0.0))


def iteration(params, x, y, z, lmbda=0.01):
    """One `bits_rdo` iteration at stage 0, as a closure."""
    ty, sy, tz, sz = rdo.STAGES[0]

    def step():
        loss, gy, gz = rdo._loss_and_grads(params, y, z, x, lmbda)
        rdo._masked_update(y, gy, ty, sy)
        rdo._masked_update(z, gz, tz, sz)
        return float(loss)

    return step


def profiled(step) -> dict:
    """One iteration under torch.profiler: kernel device time, the top
    kernels and the convolution ops by input shape."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:TOP]
    # the lowest conv ops that reach cuDNN: the forward conv and the
    # backward (input gradient) call, each with its input shapes
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::cudnn_convolution",
                          "aten::convolution_backward")
             and _op_device_us(e) > 0]
    convs = sorted(convs, key=_op_device_us, reverse=True)[:TOP]
    return {"wall_ms": wall_ms, "device_kernel_ms": total_ms,
            "busy_share": total_ms / wall_ms,
            "top_kernels": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3,
                             "count": e.count} for e in top],
            "top_conv_ops": [{"op": e.key, "shapes": e.input_shapes[:2],
                              "ms": _op_device_us(e) / 1e3,
                              "count": e.count} for e in convs]}


def run(dev, mode, hw, iters) -> dict:
    model = IntraNoAR(init_intra_noar(torch.Generator().manual_seed(0), 192),
                      device=dev, precision=mode)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1, *hw, 3), generator=gen, device=dev)
    params = model.flat_params()
    with torch.no_grad(), model.scope():
        y, z = model.get_y_z(x)
        trace = []
        rdo.bits_rdo(params, y, z, x, 0.01, max_iter=iters,
                     iter_to_exit=iters + 1, iter_to_reduce=iters + 1,
                     trace=trace)
        stamps = [t for _, t in trace]
        ms_per_iter = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
        step = iteration(params, x, y, z)
        flops = frame_flops(step)
        span_ms, fwd_convs = conv_spans(step)
        prof = profiled(step)
    return {"mode": mode, "bl_hw": list(hw), "iters": len(trace),
            "ms_per_iter": ms_per_iter,
            "losses": [loss for loss, _ in trace],
            "tflop_per_iter": flops / 1e12, "device_span_ms": span_ms,
            "top_forward_convs": fwd_convs, **prof}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--hw", default="576x960", help="BL HxW (padded)")
    parser.add_argument("--modes", nargs="+", default=["fp32", "bf16"])
    args = parser.parse_args(argv)
    if args.iters < 2:
        parser.error("--iters must be at least 2 (one interval)")
    dev = require_cuda()
    smi = card()
    hw = tuple(int(v) for v in args.hw.split("x"))
    for mode in args.modes:
        print(json.dumps({"card": smi, **run(dev, mode, hw, args.iters)}),
              flush=True)


if __name__ == "__main__":
    main()
