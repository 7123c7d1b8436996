"""Time the trainer's step on the card and break it down.

    python -m lssvc_tpu_torch.tools.train_bench [--loss pair] [--crop 256]
        [--batch 1] [--precision high] [--steps 6] [--deterministic]

One JSON line: the card, s a step and frames/s over the steps after a
warm-up one (the CLI's synthetic batches, drawn and moved to the card
each step, as `python -m lssvc_tpu_torch.train` does), each step split
into the batch draw, the forward and backward (`parallel.train.
value_and_grad`) and the optimizer (`Adam.update` and `apply_updates`),
each timed on the host clock between synchronisations, the peak GiB, and
a profile of one more step (`torch.profiler`): the device's kernel time,
its share of the step's wall time, the kernel launches, and the ten
kernels with the most device time, the warps' backward kernels among
them.  `--deterministic` runs every step under
`torch.use_deterministic_algorithms(True)` (`tools/warp_bench.py`
`deterministic`, which also sets cuBLAS's workspace): the backward
wrappers' fixed-order variants, reproducible training's cost.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from ..models.init import init_intra_ss, init_lssvc
from ..ops.nn import Mode, precision_scope
from ..parallel import train as ptrain
from ..train import SyntheticPairs, make_batch
from .timing import card, require_cuda
from .warp_bench import deterministic


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--loss", default="pair", choices=ptrain.LOSSES)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--precision", default="high",
                   choices=["fp32", "high", "bf16"])
    p.add_argument("--frames", type=int, default=3,
                   help="chain length for --loss cascade")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--deterministic", action="store_true",
                   help="under torch.use_deterministic_algorithms(True)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = require_cuda()
    with deterministic() if args.deterministic else contextlib.nullcontext():
        run(args, dev)


def run(args, dev):
    gen = torch.Generator().manual_seed(0)
    init = init_intra_ss if args.loss == "intra" else init_lssvc
    params = {k: v.to(dev) for k, v in init(gen).items()}
    opt = ptrain.Adam(1e-4)
    state = opt.init(params)
    loss_fn = ptrain.make_loss_fn(0.01, (args.crop, args.crop),
                                  loss=args.loss)
    data = SyntheticPairs(args.crop, 0)
    mode = Mode(args.precision)

    def step(params, state, split):
        t0 = time.perf_counter()
        batch, fpi = make_batch(data, args.loss, args.batch, args.frames,
                                dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with precision_scope(mode):
            _, metrics, grads = ptrain.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        upd, state = opt.update(grads, state, params)
        params = ptrain.apply_updates(params, upd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split.append((t1 - t0, t2 - t1, t3 - t2))
        return params, state, fpi, float(metrics["loss"])

    warm = []
    params, state, fpi, _ = step(params, state, warm)
    torch.cuda.reset_peak_memory_stats()
    split = []
    for _ in range(args.steps):
        params, state, fpi, loss = step(params, state, split)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(split)
    s_step = sum(map(sum, split)) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_split = []
    with torch.profiler.profile(activities=acts) as prof:
        params, state, _, _ = step(params, state, prof_split)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    print(json.dumps({
        "card": card(), "loss": args.loss, "crop": args.crop,
        "batch": args.batch, "precision": args.precision, "steps": n,
        "deterministic": args.deterministic,
        "s_per_step": s_step, "frames_per_s": args.batch * fpi / s_step,
        "split_s": {"batch": sum(s[0] for s in split) / n,
                    "forward_backward": sum(s[1] for s in split) / n,
                    "optimizer": sum(s[2] for s in split) / n},
        "peak_gib": peak, "last_loss": loss,
        "profiled_step_s": sum(prof_split[0]),
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / sum(prof_split[0]),
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total
                         / 1e3, "count": e.count} for e in top]}))


if __name__ == "__main__":
    main()
