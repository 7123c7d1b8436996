#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: compiles the kernels of lssvc_tpu_torch/csrc with nvcc (sm_90a),
   one nvcc per source, all at once; counts the tensor-core instructions
   (HGMMA, HMMA) in conv_chain's SASS (cuobjdump), and fails without HGMMA.
3. Main path: LSSVC from the port's random init, fp32 (TF32 off), offset cap
   10 px, EL 1152x1920 / BL 576x960 from a random decoded-picture buffer.
   A warm-up frame records the shape of every kernel launch (flow_warp,
   its pair entry point, grouped_warp); then a chain of K=3 frames runs
   with the launch counts set to 0 just before it, and they must read 14*K
   flow_warp (pairs included) and K grouped_warp launches after it.
   Prints s/frame, peak memory and the launch counts.
4. Kernels: each CUDA kernel bit for bit against its plain PyTorch version
   on the card, at every shape the warm-up frame launched it with (which
   must be tools/warp_bench.py's), plus edge cases (unaligned rows, batch
   2, bf16, flows and offsets far past the borders, NaN flows, a data
   pointer one element past alignment, and tensors past 2^31 elements,
   where the kernels offset in 64 bits).  Then warp_bench's times: each
   launch of a frame on its own line with its bound, their sum, the EL
   pair as one whole flow_warp_pair call, grouped_warp on smooth and on
   random flows, beside the plain versions and the one PyTorch call
   computing the same function where one exists.
5. Whole path, CPU against card: one two-layer P-frame at EL 128x128 /
   BL 64x64 from the same weights on both devices (plain warps on the CPU,
   kernels on the card); bits within 3e-3 relative, recon within 5%
   relative RMS.
6. Conv-chain path: the port's conv-chain bench (tools/convchain_bench.py)
   at its defaults, 1x1152x1920x48, 4 layers, in bf16 and in fp32, with the
   conv_chain count set to 0 just before and read just after; each call
   must launch once.  Then edge chains, each against conv_chain_plain with
   one launch per image: a mixed spec chain with biases at 1x576x960x64,
   the bench chain at 1x1150x1918 (unaligned), at 2x576x960 (batch 2, equal
   to its images one by one), and at 128 channels (its f32 slots outgrow
   shared memory), and a 3-channel head conv into a 16-channel mixed chain
   at 1x576x960 (K padded to 16).  f32: max |err| <= 1e-5 max|ref|; bf16:
   relative RMS <= 1e-3 and max |err| <= 2^-5 max|ref|.  Times the kernel,
   the plain version and the unfused cuDNN chain; prints each mode's
   executed-work factor (the kernel's tensor-core products, halo and
   padding included, over the chain's) and executed TFLOP/s.
7. Warp-tier path: the port's warp tier bench (tools/warp_tier_bench.py),
   every variant of the JAX one at its shapes, with the warp counts set to
   0 just before and read just after; each variant through flow_warp /
   grouped_warp launches its kernel once and equals the plain version
   within check_equal's tolerance; then each kernel's plain version,
   library call and bound at those shapes.

Then one JSON line {"kernels": [...]}: each kernel's launches counted on its
path (the warps on the P-frame chain of phase 3, with their warp-tier path
counts beside them; conv_chain on the conv-chain path of phase 6), its
times, bound and errors.  The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lssvc_tpu_torch import build
from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops import conv_chain as cc
from lssvc_tpu_torch.ops import warp as plain
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.tools import convchain_bench, warp_bench, warp_tier_bench
from lssvc_tpu_torch.tools.timing import card, time_ms
from lssvc_tpu_torch.tools.warp_bench import (bound_ms, flow_warp_cost,
                                              grouped_cost, uniform)

EL_HW, BL_HW, K = (1152, 1920), (576, 960), 3
# H100 SXM tensor-core peaks from NVIDIA's data sheet (the memory and f32
# rates are tools/warp_bench.py's)
BF16_TENSOR_FLOP_PER_S = 989e12  # dense, tensor cores
TF32_TENSOR_FLOP_PER_S = 495e12  # dense, tensor cores
DTYPES = {0: torch.float32, 1: torch.bfloat16}  # the kernels' dtype codes
FLOW_WARP_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:305 (_warp_kernel_cblock), "
    "lssvc_tpu/ops/warp_pallas.py:151 (_warp_kernel), "
    "lssvc_tpu/ops/warp_pallas.py:477 (_warp_kernel_cblock_roll), "
    "lssvc_tpu/ops/warp_pallas.py:407 (_warp_kernel_cblock_wide), "
    "lssvc_tpu/ops/warp_pallas.py:232 (_warp_kernel_smallflow)")
GROUPED_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:647 (_grouped_warp_kernel_cblock), "
    "lssvc_tpu/ops/warp_pallas.py:892 (_grouped_warp_kernel), "
    "lssvc_tpu/ops/warp_pallas.py:859 (_grouped_warp_kernel_smallflow)")
SOURCE = "lssvc_tpu_torch/csrc/warp.cu"
CHAIN_SOURCE = "lssvc_tpu_torch/csrc/conv_chain.cu"
CHAIN_REPLACES = "lssvc_tpu/ops/conv_chain.py:64 (_chain_kernel)"
# conv_chain edge cases: the mixed chain, then the bench chain unaligned,
# in a batch of 2, and at 128 channels, then a 3-channel head
CHAIN_EDGES = [(1, 576, 960, 64), (1, 1150, 1918, 48), (2, 576, 960, 48),
               (1, 576, 960, 128), (1, 576, 960, 3)]


def log(msg):
    print(msg, flush=True)


class LaunchRecorder:
    """Stands in for the kernel library and records every launch's shape
    and dtype code: flow_warp (n, h, w, c); flow_warp_pair (n, h, w, ca,
    cb); grouped_warp (n, h, w, c_src, go, group_num)."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def lssvc_flow_warp(self, *args):
        self.calls.append(("flow_warp", tuple(args[3:7]), args[7]))
        return self.lib.lssvc_flow_warp(*args)

    def lssvc_flow_warp_pair(self, *args):
        self.calls.append(("flow_warp_pair", tuple(args[5:10]), args[10]))
        return self.lib.lssvc_flow_warp_pair(*args)

    def lssvc_grouped_warp(self, *args):
        self.calls.append(("grouped_warp", tuple(args[5:11]), args[11]))
        return self.lib.lssvc_grouped_warp(*args)


def grid_sample_ms(x, flow):
    """Time of the one PyTorch call that computes flow_warp:
    F.grid_sample(bilinear, border, align_corners=True) on x's NCHW view."""
    _, h, w, _ = x.shape
    iy = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None]
    ix = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :]
    grid = torch.stack([(ix + flow[..., 0]) / ((w - 1) / 2) - 1,
                        (iy + flow[..., 1]) / ((h - 1) / 2) - 1], -1)
    x_nchw = x.permute(0, 3, 1, 2)
    return time_ms(lambda: F.grid_sample(
        x_nchw, grid, mode="bilinear", padding_mode="border",
        align_corners=True))


def chain_cost(specs, n, h, w, c_in, elt):
    """Bytes: the input read once, the output written once, the f32 weights
    and biases read once.  Operations per pixel: 2*9*ci*co for a conv3,
    2*ci*co for a conv1, 2*9*c for a dw3, one per output channel for a bias,
    a leaky ReLU, an act or an add."""
    cur, flops, params = c_in, 0, 0
    for s in specs:
        kind = s["kind"]
        if kind == "save":
            continue
        if kind in ("act", "add_saved"):
            flops += cur
            continue
        co = s["w"].shape[0]
        taps = 1 if kind == "conv1" else 9
        macs = taps * co if kind == "dw3" else taps * cur * co
        flops += 2 * macs + co * ((s.get("b") is not None)
                                  + (s.get("slope") is not None))
        params += macs + co
        if not s.get("branch"):
            cur = co
    return n * h * w * (c_in + cur) * elt + 4 * params, n * h * w * flops


def chain_peak(dtype):
    """The rate of the unit the kernel uses: bf16 tensor cores, or for f32
    the TF32 tensor cores at three TF32 products per f32 product."""
    return BF16_TENSOR_FLOP_PER_S if dtype == torch.bfloat16 \
        else TF32_TENSOR_FLOP_PER_S / 3


def check_chain(name, errs, dtype):
    """f32: max |err| <= 1e-5 max|ref|; bf16: relative RMS <= 1e-3 and max
    |err| <= 2^-5 max|ref|."""
    err, top, rms = errs["max_abs_err"], errs["max_abs_ref"], errs["rel_rms"]
    ok = (err <= 1e-5 * top if dtype == torch.float32
          else rms <= 1e-3 and err <= 2.0 ** -5 * top)
    log(f"  {name}: max |err| {err:.3g} at max |ref| {top:.3g}, "
        f"relative RMS {rms:.3g}")
    if not ok:
        raise AssertionError(f"{name}: beyond tolerance")
    return err


def check_equal(name, out, ref, x):
    """fp32: max |err| <= 1e-5 * max|x|; bf16: within one bf16 ulp of the
    plain version (computed in f32, rounded once).  NaN must meet NaN."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    o, r = out.float(), ref.float()
    nan_o, nan_r = torch.isnan(o), torch.isnan(r)
    if not torch.equal(nan_o, nan_r):
        raise AssertionError(f"{name}: NaN positions differ")
    o, r = o.masked_fill(nan_o, 0), r.masked_fill(nan_r, 0)
    err = (o - r).abs()
    if out.dtype == torch.float32:
        tol = 1e-5 * float(x.float().abs().max())
        ok = float(err.max()) <= tol
    else:
        ok = bool((err <= r.abs() * 2.0 ** -7 + 1e-30).all())
    if not ok:
        raise AssertionError(f"{name}: max |err| {float(err.max())} beyond "
                             "tolerance")
    log(f"  {name}: max |err| {float(err.max()):.3g}")
    return float(err.max())


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    smi = card()
    log(smi)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    names = ("warp", "conv_chain")
    build.build_all(names)
    for name in names:
        build.load(name)
    log(f"# build: " + ", ".join(
        f"{n}.cu {build.BUILD_SECONDS[n]:.2f} s nvcc" for n in names)
        + f"; {time.perf_counter() - t0:.2f} s to build all and load")
    # the conv chain's products: tensor-core instructions in its SASS
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(build.library_path("conv_chain"))],
        capture_output=True, text=True, check=True).stdout
    hgmma = sass.count("HGMMA")
    log(f"# conv_chain.cu SASS: {hgmma} HGMMA, {sass.count('HMMA')} HMMA")
    if hgmma == 0:
        raise AssertionError("conv_chain.cu has no HGMMA instruction")


def check_bits(name, out, ref):
    """Bit for bit against the plain version, NaN meeting NaN."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    o, r = out.masked_fill(nan_o, 0), ref.masked_fill(nan_r, 0)
    if not (torch.equal(nan_o, nan_r) and torch.equal(o, r)):
        raise AssertionError(f"{name}: not bit-equal, max |err| "
                             f"{float((o.float() - r.float()).abs().max())}")
    log(f"  {name}: bit-equal")
    return 0.0


def misaligned(t):
    """A copy of t at storage offset 1: its data starts one element past
    an aligned address, as a view into a larger tensor may."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view(t.shape).copy_(t)


def check_flow(name, xs, flow):
    """flow_warp of xs[0], or flow_warp_pair of xs[0] and xs[1], in one
    launch, against the plain warp of each tensor."""
    n0 = wk.flow_warp.launches
    outs = ([wk.flow_warp(xs[0], flow)] if len(xs) == 1
            else wk.flow_warp_pair(*xs, flow))
    if wk.flow_warp.launches != n0 + 1:
        raise AssertionError(f"{name}: {wk.flow_warp.launches - n0} launches")
    return max(check_bits(f"{name} [{i}]", out, plain.flow_warp(x, flow))
               for i, (out, x) in enumerate(zip(outs, xs)))


def check_grouped(name, x, fx, fy, m, gn):
    n0 = wk.grouped_warp.launches
    out = wk.grouped_warp(x, fx, fy, m, gn)
    if wk.grouped_warp.launches != n0 + 1:
        raise AssertionError(f"{name}: {wk.grouped_warp.launches - n0} "
                             "launches")
    return check_bits(name, out, plain.grouped_warp_plain(x, fx, fy, m, gn))


def phase_kernels(dev, calls):
    """Each CUDA kernel bit for bit against its plain version at every
    shape the warm-up frame launched it with (`calls`, from LaunchRecorder,
    which must be tools/warp_bench.py's FRAME and GROUPED) and at edge
    cases; then warp_bench's times at those shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(shape, lo, hi):
        return uniform(gen, shape, lo, hi)

    flow_calls = [(name, shape) for name, shape, _ in calls
                  if name != "grouped_warp"]
    grouped_calls = [shape for name, shape, _ in calls
                     if name == "grouped_warp"]
    if (flow_calls != warp_bench.FRAME
            or grouped_calls != [warp_bench.GROUPED]
            or {DTYPES[dt] for _, _, dt in calls} != {torch.float32}):
        raise AssertionError(f"main path launched {calls}; warp_bench times "
                             f"{warp_bench.FRAME} and {warp_bench.GROUPED}")
    f32, bf16 = torch.float32, torch.bfloat16

    log("# flow_warp and flow_warp_pair against the plain version")
    errs = []
    for name, shape in warp_bench.FRAME:
        xs, flow = warp_bench.flow_inputs(gen, shape)
        errs.append(check_flow(f"{name} {shape} frame launch", xs, flow))
    n, h, w, ca, cb = warp_bench.EL_PAIR
    a, b = uni((n, h, w, ca), -1, 1), uni((n, h, w, cb), -1, 1)
    for label, lo in (("|f|<=2", 2.0), ("|f|<=25", 25.0),
                      ("|f|<=300 past borders", 300.0)):
        errs.append(check_flow(f"pair {warp_bench.EL_PAIR} {label}", [a, b],
                               uni((n, h, w, 2), -lo, lo)))
    flow_small = uni((n, h, w, 2), -2, 2)
    errs.append(check_flow("bf16 pair |f|<=2", [a.to(bf16), b.to(bf16)],
                           flow_small))
    flow_nan = flow_small.clone()
    flow_nan[0, 100:110, 200:260, 0] = float("nan")
    errs.append(check_flow("pair NaN flows", [a, b], flow_nan))
    # unaligned rows, batch 2, both dtypes: scalar (3) and vector paths
    for shape in ((1, 1150, 1918, 3), (1, 1150, 1918, 48), (2, 576, 960, 64)):
        flow = uni(shape[:3] + (2,), -25, 25)
        for dtype in (f32, bf16):
            errs.append(check_flow(f"{str(dtype)[6:]} {shape} |f|<=25",
                                   [uni(shape, -1, 1).to(dtype)], flow))
    errs.append(check_flow("pair (2, 575, 957, 3 + 64) |f|<=25",
                           [uni((2, 575, 957, 3), -1, 1),
                            uni((2, 575, 957, 64), -1, 1)],
                           uni((2, 575, 957, 2), -25, 25)))
    # a data_ptr one element past 16-byte alignment takes the scalar path
    x = uni((1, 576, 960, 48), -1, 1)
    flow = uni((1, 576, 960, 2), -25, 25)
    errs.append(check_flow("(1, 576, 960, 48) at storage offset 1",
                           [misaligned(x)], flow))
    errs.append(check_flow("pair 3 + 48, b at storage offset 1",
                           [x[..., :3].contiguous(), misaligned(x)], flow))
    # past 2^31 elements the kernel offsets in 64 bits: a pair of a
    # scalar-path tensor past 2^31 elements and a vector-path one.  The warp
    # is per channel, so a is held against its first and last channels,
    # which hold the smallest and the largest offsets
    big = (1, h, w, 2 ** 31 // (h * w) + 1)
    a_big = torch.empty(big, dtype=bf16, device=dev).uniform_(
        -1, 1, generator=gen)
    b16 = uni((1, h, w, 16), -1, 1).to(bf16)
    flow = uni((1, h, w, 2), -25, 25)
    out_a, out_b = wk.flow_warp_pair(a_big, b16, flow)
    errs.append(check_bits(f"bf16 pair with a {big}: b {tuple(b16.shape)}",
                           out_b, plain.flow_warp(b16, flow)))
    for chans in (slice(0, 4), slice(-4, None)):
        xs = a_big[..., chans].contiguous()
        errs.append(check_bits(
            f"bf16 pair a {big} ({math.prod(big)} elements) channels "
            f"{chans.start}:{chans.stop or ''}", out_a[..., chans],
            plain.flow_warp(xs, flow)))
    del a_big, out_a, out_b, xs

    log("# grouped_warp against the plain version")
    g_errs = []
    n, h, w, c_src, go, gn = warp_bench.GROUPED
    g_errs.append(check_grouped(f"{warp_bench.GROUPED} frame launch",
                                *warp_bench.grouped_inputs(gen), gn))
    # batch 2, unaligned rows, both dtypes, offsets to 300 px past the
    # borders, NaN offsets, and x at storage offset 1 (one load a channel)
    shape, units = (2, 290, 478, c_src), (2, 290, 478, go)
    m = uni(units, 0, 1)
    for dtype in (f32, bf16):
        x = uni(shape, -1, 1).to(dtype)
        for off in (0.4, 12.0, 50.0, 300.0):
            fx, fy = uni(units, -off, off), uni(units, -off, off)
            g_errs.append(check_grouped(
                f"{str(dtype)[6:]} {shape} |off|<={off:g}", x, fx, fy, m, gn))
        fx[0, 10:20, 30:90, 5] = float("nan")
        fy[1, 200:210, 0:40, 20] = float("nan")
        g_errs.append(check_grouped(f"{str(dtype)[6:]} {shape} NaN offsets",
                                    x, fx, fy, m, gn))
        g_errs.append(check_grouped(
            f"{str(dtype)[6:]} {shape} at storage offset 1", misaligned(x),
            fx, fy, m, gn))
    # another shape takes the kernel's runtime constants: 8 units, 4 groups
    u8 = (2, 290, 478, 8)
    g_errs.append(check_grouped(
        f"{u8} x 8 units, 4 groups |off|<=12", uni(u8, -1, 1),
        uni(u8, -12, 12), uni(u8, -12, 12), uni(u8, 0, 1), 4))
    # past 2^31 output elements (64-bit offsets): images are independent,
    # so the first and the last are held against the plain version
    nb = 11
    xb = uni((nb, h, w, c_src), -1, 1).to(bf16)
    fxb, fyb = uni((nb, h, w, go), -12, 12), uni((nb, h, w, go), -12, 12)
    mb = uni((nb, h, w, go), 0, 1)
    out = wk.grouped_warp(xb, fxb, fyb, mb, gn)
    for i in (0, nb - 1):
        im = slice(i, i + 1)
        g_errs.append(check_bits(
            f"bf16 {tuple(xb.shape)} x {go} units ({out.numel()} output "
            f"elements) image {i}", out[im],
            plain.grouped_warp_plain(xb[im], fxb[im], fyb[im], mb[im], gn)))
    del xb, fxb, fyb, mb, out

    log("# warp times at the frame's shapes (tools/warp_bench.py)")
    bench = warp_bench.run(dev)
    for f in bench["frame"]:
        log(f"  {f['call']} {tuple(f['shape'])}: {f['ms']:.4f} ms, bound "
            f"{f['bound_ms']:.4f} ms")
    n, h, w, ca, cb = warp_bench.EL_PAIR
    xs, flow = warp_bench.flow_inputs(gen, warp_bench.EL_PAIR)
    plain_ms = time_ms(lambda: plain.flow_warp(torch.cat(xs, -1), flow), 5, 1)
    library_ms = grid_sample_ms(torch.cat(xs, -1), flow)
    b_ms, b_by = bound_ms(*flow_warp_cost(n, h, w, ca + cb, 4))
    fw_entry = {
        "name": "flow_warp", "route": "cuda", "source": SOURCE,
        "replaces": FLOW_WARP_REPLACES, "call": "flow_warp_pair",
        "shape": list(warp_bench.EL_PAIR), "dtype": "float32",
        "max_abs_err": max(errs), "ms": bench["pair_ms"],
        "pair_ms": bench["pair_ms"], "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": "F.grid_sample(bilinear, border, align_corners=True)"
                        " on the two tensors' concat",
        "ms_random_flows": bench["pair_ms_random_flows"],
        "frame_ms": bench["frame_ms"],
        "frame_bound_ms": bench["frame_bound_ms"],
    }
    log(f"# flow_warp_pair at the EL pair {bench['pair_ms']:.4f} ms, "
        f"{bench['pair_ms_random_flows']:.4f} ms on random flows (bound "
        f"{b_ms:.4f}, plain {plain_ms:.4f}, grid_sample {library_ms:.4f}); "
        f"the {len(bench['frame'])} launches of a frame "
        f"{bench['frame_ms']:.4f} ms (bound {bench['frame_bound_ms']:.4f})")
    del xs, flow

    x, fx, fy, m = warp_bench.grouped_inputs(gen)
    plain_ms = time_ms(lambda: plain.grouped_warp_plain(x, fx, fy, m, gn),
                       3, 1)
    del x, fx, fy, m
    grouped = bench["grouped"]
    b_ms, b_by = bound_ms(*grouped_cost(*warp_bench.GROUPED, 4))
    gw_entry = {
        "name": "grouped_warp", "route": "cuda", "source": SOURCE,
        "replaces": GROUPED_REPLACES, "shape": [n, h, w, c_src],
        "units": go, "dtype": "float32", "max_abs_err": max(g_errs),
        "ms": grouped["ms"], "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_random_flows": grouped["ms_random_flows"],
    }
    log(f"# grouped_warp {grouped['ms']:.4f} ms, "
        f"{grouped['ms_random_flows']:.4f} ms on random flows (bound "
        f"{b_ms:.4f}, plain {plain_ms:.4f})")
    return [fw_entry, gw_entry]


def _rel_rms(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b ** 2)).clamp_min(1e-12))


def phase_cpu_vs_card(dev):
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    args = [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]
    outs = []
    for device in ("cpu", dev):
        model = LSSVC(params, device=device,
                      od_offset_cap=OD_OFFSET_CAP_SERVING)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        outs.append(model.forward_one_frame(*(a.to(device) for a in args)))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        a, b = float(card[k]), float(cpu[k])
        if not abs(a - b) <= 3e-3 * max(abs(b), 1.0):
            raise AssertionError(f"{k}: card {a} vs cpu {b}")
    rms = {k: _rel_rms(card["dpb"][k], cpu["dpb"][k])
           for k in ("ref_frame_bl", "ref_frame_el")}
    if max(rms.values()) > 0.05:
        raise AssertionError(f"recon relative RMS {rms}")
    log(f"# cpu vs card at 128x128: bits card {float(card['bit_bl']):.3f}/"
        f"{float(card['bit_el']):.3f} cpu {float(cpu['bit_bl']):.3f}/"
        f"{float(cpu['bit_el']):.3f}, recon rel RMS {rms}")


def mixed_chain(c, seed):
    """save, conv3 (bias, slope), a conv1 branch under a tag, dw3, act,
    conv3, add_saved(tag), add_saved; a nonzero bias on every conv."""
    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen) * (2.0 / (shape[1] * 9)) ** .5

    def b(c):
        return torch.randn(c, generator=gen) * 0.1

    return [{"kind": "save"},
            {"kind": "conv3", "w": w(c, c, 3, 3), "b": b(c), "slope": 0.1},
            {"kind": "conv1", "w": w(c, c, 1, 1), "b": b(c), "branch": "a"},
            {"kind": "dw3", "w": w(c, 1, 3, 3) * 3, "b": b(c), "slope": 0.01},
            {"kind": "act", "slope": 0.2},
            {"kind": "conv3", "w": w(c, c, 3, 3), "b": b(c)},
            {"kind": "add_saved", "tag": "a"},
            {"kind": "add_saved"}]


def head_chain(seed):
    """A 3 -> 16 channel conv3 head (bias, slope) before the mixed chain at
    16 channels."""
    gen = torch.Generator().manual_seed(seed)
    return [{"kind": "conv3", "w": torch.randn((16, 3, 3, 3), generator=gen)
             * (2.0 / 27) ** .5, "b": torch.randn(16, generator=gen) * 0.1,
             "slope": 0.1}] + mixed_chain(16, seed)


def phase_conv_chain(dev):
    """The conv-chain bench at its defaults (the path, counted), then edge
    chains against the plain version (uncounted)."""
    log("# conv-chain path: tools/convchain_bench.py at 1x1152x1920x48 x4")
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    cc.conv_chain.launches = 0
    runs = {mode: convchain_bench.run(mode) for mode in dtypes}
    launches = cc.conv_chain.launches
    for mode, run in runs.items():
        log(json.dumps(run))
        check_chain(f"bench {mode}", run["chain"], dtypes[mode])
        if run["chain"]["launches_per_call"] != 1:
            raise AssertionError(f"bench {mode}: {run['chain']} launches")
    if launches == 0:
        raise AssertionError("the conv-chain path launched no kernel")

    log("# conv_chain edge chains against the plain version")
    errs = []
    edges = [(f"mixed {CHAIN_EDGES[0]}", mixed_chain(CHAIN_EDGES[0][-1], 1),
              CHAIN_EDGES[0])]
    for shape in CHAIN_EDGES[1:-1]:
        specs = convchain_bench.make_chain(shape[-1], 4, 8, 8,
                                           device="cpu")[1]
        edges.append((f"bench chain {shape}", specs, shape))
    edges.append((f"3-channel head {CHAIN_EDGES[-1]}", head_chain(2),
                  CHAIN_EDGES[-1]))
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, specs, shape in edges:
        x = uniform(gen, shape, -1, 1)
        for mode, dtype in dtypes.items():
            chain = cc.ConvChain(specs, shape[-1], dtype, dev)
            n0 = cc.conv_chain.launches
            out = chain(x)
            if cc.conv_chain.launches - n0 != shape[0]:
                raise AssertionError(f"{name}: {cc.conv_chain.launches - n0}"
                                     f" launches for {shape[0]} images")
            where = "shared" if chain.in_shared_memory else "global"
            errs.append(check_chain(
                f"{mode} {name}, tile {chain.tile}, slots in {where} memory",
                convchain_bench.errors(out, cc.conv_chain_plain(x, specs,
                                                                dtype)),
                dtype))
            if shape[0] > 1 and not torch.equal(out[1:], chain(x[1:])):
                raise AssertionError(f"{name}: image 1 differs from its "
                                     "own launch")

    entry = {"name": "conv_chain", "route": "cuda", "source": CHAIN_SOURCE,
             "replaces": CHAIN_REPLACES, "launches": launches,
             "max_abs_err": max(errs + [r["chain"]["max_abs_err"]
                                        for r in runs.values()]),
             "library_call": "F.conv2d + F.leaky_relu per layer, "
                             "channels_last, compute dtype (cuDNN)"}
    specs = convchain_bench.make_chain(h=8, w=8, device="cpu")[1]
    for mode, run in runs.items():
        dtype = dtypes[mode]
        nbytes, chain_flops = chain_cost(specs, *run["shape"],
                                         dtype.itemsize)
        b_ms, b_by = bound_ms(nbytes, chain_flops, chain_peak(dtype))
        ms = run["chain"]["ms"]
        numbers = {"shape": run["shape"], "dtype": mode, "ms": ms,
                   "plain_ms": run["plain_version_ms"],
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": run["plain"]["ms"], "tile": run["tile"],
                   "executed_factor": run["executed_gflop"] * 1e9
                   / chain_flops,
                   "executed_tflops": run["executed_gflop"] / ms}
        if mode == "bf16":  # the bench's default mode heads the entry
            entry.update(numbers)
        else:
            entry[mode] = numbers
        log(f"# conv_chain {mode}: {numbers['ms']:.3f} ms (bound "
            f"{b_ms:.4f} by {b_by}, plain {numbers['plain_ms']:.3f}, cuDNN "
            f"chain {numbers['library_ms']:.3f}); tile {run['tile']}, "
            f"executed-work factor {numbers['executed_factor']:.3f}, "
            f"{numbers['executed_tflops']:.1f} TFLOP/s executed"
            + (f" ({3 * numbers['executed_tflops']:.1f} in TF32 products)"
               if mode == "fp32" else ""))
    return entry


def phase_warp_tiers(dev):
    """Every variant of the warp tier bench (the path, counted)."""
    log("# warp-tier path: tools/warp_tier_bench.py at 1x1152x1920x48")
    inp = warp_tier_bench.make_inputs(dev)
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    rows = warp_tier_bench.run(inp, check=check_equal)
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    for row in rows:
        log(json.dumps(row))
        want = {k: int(k == row["kernel"])  # a shift sum launches none
                for k in ("flow_warp", "grouped_warp")}
        if row["launches_per_call"] != want:
            raise AssertionError(f"{row['name']}: launched "
                                 f"{row['launches_per_call']}, want {want}")
    if min(launches.values()) == 0:
        raise AssertionError(f"warp-tier path launches {launches}")
    # each kernel's yardsticks at the bench's shapes (outside the count)
    x, flow = inp["x"], inp["flow"]
    units = (inp["fx"], inp["fy"], inp["mask"])
    n, h, w, c = x.shape
    go, gn = units[0].shape[-1], warp_tier_bench.GROUPS
    elt = x.element_size()
    numbers = {
        "flow_warp": {
            "plain_ms": time_ms(lambda: plain.flow_warp(x, flow), 5, 1),
            "library_ms": grid_sample_ms(x, flow),
            "bound_ms": bound_ms(*flow_warp_cost(n, h, w, c, elt))[0]},
        "grouped_warp": {
            "plain_ms": time_ms(
                lambda: plain.grouped_warp_plain(x, *units, gn), 3, 1),
            "library_ms": None,
            "bound_ms": bound_ms(*grouped_cost(n, h, w, c, go, gn, elt))[0]}}
    for name, nums in numbers.items():
        nums["launches"] = launches[name]
        nums["ms"] = {r["name"]: r["ms"] for r in rows
                      if r["launches_per_call"][name]}
        log(f"# {name} on the warp-tier path: {json.dumps(nums)}")
    return numbers


def phase_main_path(dev):
    params = init_lssvc(torch.Generator().manual_seed(0))
    model = LSSVC(params, device=dev, od_offset_cap=OD_OFFSET_CAP_SERVING)
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 parity mode must turn TF32 off")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    x_bl, x_el = uni(*BL_HW, 3), uni(*EL_HW, 3)
    dpb0 = {"ref_frame_bl": uni(*BL_HW, 3), "ref_frame_el": uni(*EL_HW, 3),
            "ref_feature_bl": uni(*BL_HW, 64),
            "ref_feature_el": uni(*EL_HW, 48)}

    def frame(dpb):
        out = model.forward_one_frame(
            x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
            dpb["ref_feature_bl"], dpb["ref_feature_el"])
        nxt = dict(out["dpb"])
        # the codec's GOP loop clamps the reference frames between frames
        # (lssvc_tpu/harness/runner.py:185-190)
        for k in ("ref_frame_bl", "ref_frame_el"):
            nxt[k] = torch.clamp(nxt[k], 0, 1)
        return out, nxt

    # warm-up, uncounted: records the shape of every kernel launch
    recorder, real_lib = LaunchRecorder(wk._lib()), wk._lib
    wk._lib = lambda: recorder
    try:
        frame(dpb0)
    finally:
        wk._lib = real_lib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    t0 = time.perf_counter()
    dpb, outs = dpb0, []
    for _ in range(K):
        out, dpb = frame(dpb)
        outs.append(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, out in enumerate(outs):
        for k in ("bit_bl", "bit_el"):
            if not math.isfinite(float(out[k])):
                raise AssertionError(f"frame {i}: {k} = {float(out[k])}")
        for k in ("ref_frame_bl", "ref_frame_el"):
            if not bool(torch.isfinite(out["dpb"][k]).all()):
                raise AssertionError(f"frame {i}: {k} not finite")
        if out["dpb"]["ref_frame_el"].shape != (1, *EL_HW, 3):
            raise AssertionError(f"frame {i}: EL recon shape "
                                 f"{tuple(out['dpb']['ref_frame_el'].shape)}")
    if launches != {"flow_warp": 14 * K, "grouped_warp": K}:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{14 * K} flow_warp and {K} grouped_warp")
    log(json.dumps({
        "main_path": "LSSVC.forward_one_frame", "el": list(EL_HW),
        "bl": list(BL_HW), "frames": K, "precision": "fp32",
        "s_per_frame": seconds / K, "peak_mem_gib": peak_gib,
        "launches": launches,
        "bits": [[float(o["bit_bl"]), float(o["bit_el"])] for o in outs]}))
    return recorder.calls, launches


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    calls, launches = phase_main_path(dev)
    kernels = phase_kernels(dev, calls)
    phase_cpu_vs_card(dev)
    chain_entry = phase_conv_chain(dev)
    tiers = phase_warp_tiers(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_frame"] = launches[k["name"]] / K
        k["warp_tier_bench"] = tiers[k["name"]]
    kernels.append(chain_entry)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
