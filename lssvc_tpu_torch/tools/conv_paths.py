"""Which path the codec's convolutions can take on the GPU.

    python -m lssvc_tpu_torch.tools.conv_paths [--dtype bf16]

Times the 3x3 conv shapes of a 1080p IntraSS I-frame (IntraNoAR's
192-channel layers at 144x240, 288x480 and 72x120, and the EL's
64-channel layers) through five PyTorch paths, all fp32 with TF32 off
(or, with `--dtype bf16`, on bf16 inputs and weights, the bf16 serving
mode's convs; then only the conv shapes are timed):

  port       `ops.conv2d`: F.conv2d on the NHWC tensor's channels_last
             view, the algorithm cuDNN's heuristic picks
  nchw       F.conv2d on a contiguous NCHW copy of the input
  benchmark  the port's call with `cudnn.benchmark` on (cuDNN times its
             algorithms on the first call and keeps the fastest)
  no_cudnn   the port's call with cuDNN off (ATen's own convolution)
  im2col     F.unfold, then one torch.matmul

Each path's output is held to a float64 conv of the same inputs (max
|err| over max |ref|).  Then one 1080p IntraSS I-frame (BL 192 channels,
random init, seed 0) runs under `port`, `benchmark` and `no_cudnn`: its
device span (CUDA events, after one warm-up frame), its bits and the
relative RMS of its EL reconstruction against the `port` frame.  Last,
one 1080p two-layer P-frame (LSSVC, random init, seed 0, cap 10 px) with
the DMC's transposed convs as the port runs them (forward convs, cuDNN
in its deterministic mode, which a stream's closed loop needs) and as
cuDNN's transposed-conv algorithms (deterministic mode off: algorithm 0
adds with atomics), in turns (cuDNN, port, port, cuDNN; 3 frames each
after a warm-up): s per frame, and whether the frame run twice gives the
same bits.
Prints one JSON line.  Needs a CUDA device.

The model runs enter the model's own mode (`precision_scope`, which turns
`cudnn.benchmark` off and `cudnn.deterministic` on) and then each cuDNN
mode inside it, so the mode timed is the one named.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from ..models import LSSVC, IntraSS, components
from ..models.init import init_intra_ss, init_lssvc
from ..ops import OD_OFFSET_CAP_SERVING, conv2d
from ..ops.nn import set_fp32_parity
from .timing import card, require_cuda, time_ms

EL_HW, BL_HW = (1152, 1920), (576, 960)
# (c_in, c_out, h, w) of the I-frame's 3x3 stride-1 convs at 1080p
SHAPES = [(192, 192, 144, 240), (192, 192, 288, 480), (192, 192, 72, 120),
          (192, 768, 144, 240), (64, 64, 576, 960), (64, 64, 1152, 1920)]


def _cudnn(enabled=True, benchmark=False, deterministic=True):
    return torch.backends.cudnn.flags(enabled=enabled, benchmark=benchmark,
                                      deterministic=deterministic,
                                      allow_tf32=False)


MODES = {"port": lambda: _cudnn(),
         "benchmark": lambda: _cudnn(benchmark=True),
         "no_cudnn": lambda: _cudnn(enabled=False)}


@contextlib.contextmanager
def _model_in(model, mode):
    """The model's calls in cuDNN `mode`, entered inside the model's own
    scope (which alone would set benchmark off, deterministic on)."""
    own = model.scope

    def scope():
        stack = contextlib.ExitStack()
        stack.enter_context(own())
        stack.enter_context(mode())
        return stack

    model.scope = scope
    try:
        yield
    finally:
        del model.scope


def _im2col(x, w, b):
    n, h, wd, _ = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), w.shape[2], padding=1)
    y = torch.matmul(w.reshape(w.shape[0], -1), cols) + b[:, None]
    return y.reshape(n, w.shape[0], h, wd).permute(0, 2, 3, 1)


def conv_paths(dev, c_in, c_out, h, w, dtype=torch.float32) -> dict:
    """ms and relative max error of each path at one shape, on inputs,
    weights and bias of `dtype` (the error against a float64 conv of the
    same values)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, h, w, c_in), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((c_out, c_in, 3, 3), generator=gen, device=dev)
          / 40).to(dtype)
    b = torch.randn((c_out,), generator=gen, device=dev).to(dtype)
    ref = conv2d(x.double(), wt.double(), b.double())
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    paths = {
        "port": (MODES["port"], lambda: conv2d(x, wt, b)),
        "nchw": (MODES["port"],
                 lambda: F.conv2d(x_nchw, wt, b, padding=1).permute(0, 2, 3, 1)),
        "benchmark": (MODES["benchmark"], lambda: conv2d(x, wt, b)),
        "no_cudnn": (MODES["no_cudnn"], lambda: conv2d(x, wt, b)),
        "im2col": (contextlib.nullcontext, lambda: _im2col(x, wt, b)),
    }
    out = {}
    for name, (mode, fn) in paths.items():
        with mode():
            err = float((fn().double() - ref).abs().max() / ref.abs().max())
            once = time_ms(fn, iters=1, warmup=1)
            ms = time_ms(fn, iters=max(3, min(30, int(300 / once))), warmup=0)
        out[name] = {"ms": ms, "rel_max_err": err}
    return out


def iframe_modes(dev) -> dict:
    """One 1080p IntraSS frame under each cuDNN mode."""
    model = IntraSS(init_intra_ss(torch.Generator().manual_seed(0), 192),
                    device=dev)
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(0)
    x_bl = torch.rand((1, *BL_HW, 3), generator=gen, device=dev)
    x_el = torch.rand((1, *EL_HW, 3), generator=gen, device=dev)
    out, base = {}, None
    for name, mode in MODES.items():
        with _model_in(model, mode):
            model.forward(x_bl, x_el)  # warm-up (and cuDNN's own timing)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = model.forward(x_bl, x_el)
            end.record()
            torch.cuda.synchronize()
        base = base or res
        diff = res["x_hat_el"] - base["x_hat_el"]
        out[name] = {
            "device_s": start.elapsed_time(end) / 1e3,
            "bits": [float(res["bit_bl"]), float(res["bit_el"])],
            "x_hat_el_rel_rms_vs_port": float(
                diff.square().mean().sqrt()
                / base["x_hat_el"].square().mean().sqrt())}
    return out


def _cudnn_transposed(x, w, b=None, stride=2, padding=1,
                      output_padding=1):
    """The DMC's transposed convs as cuDNN's own (nondeterministic)
    algorithms run them: the port's path before it took forward convs."""
    return F.conv_transpose2d(
        x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding,
        output_padding=output_padding).permute(0, 2, 3, 1).contiguous()


def pframe_deconv_paths(dev) -> dict:
    """One 1080p P-frame with the DMC's transposed convs as the port runs
    them (forward convs, cuDNN deterministic) and as cuDNN's transposed
    convs (deterministic mode off), in turns."""
    model = LSSVC(init_lssvc(torch.Generator().manual_seed(0)), device=dev,
                  od_offset_cap=OD_OFFSET_CAP_SERVING)
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(0)
    args = [torch.rand((1, *hw, c), generator=gen, device=dev)
            for hw, c in ((BL_HW, 3), (EL_HW, 3), (BL_HW, 3), (EL_HW, 3),
                          (BL_HW, 64), (EL_HW, 48))]
    paths = {"port": (components.conv_transpose2d, MODES["port"]),
             "cudnn_transposed": (_cudnn_transposed,
                                  lambda: _cudnn(deterministic=False))}
    out = {name: {"s_per_frame": [], "repeats_equal": True}
           for name in paths}
    port_fn = components.conv_transpose2d
    try:
        for name in ("cudnn_transposed", "port", "port", "cudnn_transposed"):
            components.conv_transpose2d, mode = paths[name]
            with _model_in(model, mode):
                first = model.forward_one_frame(*args)["dpb"]
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    again = model.forward_one_frame(*args)["dpb"]
                end.record()
                torch.cuda.synchronize()
            out[name]["s_per_frame"].append(start.elapsed_time(end) / 3e3)
            out[name]["repeats_equal"] &= all(
                torch.equal(first[k], again[k]) for k in first)
    finally:
        components.conv_transpose2d = port_fn
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    args = p.parse_args(argv)
    dev = require_cuda()
    set_fp32_parity()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    convs = [{"c_in": ci, "c_out": co, "hw": [h, w],
              **conv_paths(dev, ci, co, h, w, dtype)}
             for ci, co, h, w in SHAPES]
    out = {"card": card(), "precision": ("fp32, TF32 off" if args.dtype ==
                                         "fp32" else "bf16 operands"),
           "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version(), "convs": convs}
    if args.dtype == "fp32":
        out.update(iframe=iframe_modes(dev), pframe=pframe_deconv_paths(dev))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
