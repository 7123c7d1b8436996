"""The fused conv-chain kernel against the unfused cuDNN chain, on the GPU.

    python -m lssvc_tpu_torch.tools.convchain_bench [--mode bf16|fp32]
        [--c 48] [--reps 4]

The twin of the JAX package's `tools/convchain_bench.py`, at its defaults:
the 1080p enhancement layer's full-resolution 3x3 stack, 1x1152x1920x48,
4 layers, leaky ReLU slope 0.01, bf16 (`--mode fp32` selectable; TF32 is
off in fp32).  Weights (normal x 0.05) and input (uniform [0, 1)) come from
a `torch.Generator` seed (`SEED`).  Variants:

  plain  the unfused chain: F.conv2d per layer on channels_last in the
         compute dtype, then the leaky ReLU (cuDNN; the library yardstick)
  chain  the fused CUDA kernel of `ops/conv_chain.py`

Each is held against `conv_chain_plain` (the kernel's rounding points) and
timed with CUDA events (`ITERS` calls); one JSON line gives the errors, the
times, the kernel's tile and executed tensor-core work (`executed_gflop`:
its products, halo and padding included, f32 products counted once) and
the card's name and power limit.  The JAX tool's `packed` variant needs the
width-packed conv domain (`ops/packed.py`, ROADMAP A8) and `nos2b` is an
XLA compiler flag; neither has a counterpart here.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..ops.conv_chain import ConvChain, conv_chain, conv_chain_plain
from ..ops.nn import set_fp32_parity
from .timing import card, require_cuda, time_ms

H, W = 1152, 1920
SLOPE = 0.01
SEED = 0
ITERS = 20
CDTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def make_chain(c=48, reps=4, h=H, w=W, device="cuda"):
    """The bench's input (1, h, w, c) and its uniform 3x3 spec chain."""
    gen = torch.Generator().manual_seed(SEED)
    weights = [torch.randn((c, c, 3, 3), generator=gen) * 0.05
               for _ in range(reps)]
    x = torch.rand((1, h, w, c), generator=gen).to(device)
    specs = [{"kind": "conv3", "w": k, "b": None, "slope": SLOPE}
             for k in weights]
    return x, specs


def library_chain(x, specs, cdtype):
    """The unfused chain in the compute dtype: F.conv2d per layer on
    channels_last tensors (cuDNN), bias and leaky ReLU, all in `cdtype`."""
    cur = x.to(cdtype).permute(0, 3, 1, 2)
    saved = {}
    for s in specs:
        kind = s["kind"]
        if kind == "save":
            saved[s.get("tag")] = cur
        elif kind == "add_saved":
            cur = cur + saved[s.get("tag")]
        elif kind == "act":
            cur = F.leaky_relu(cur, s["slope"])
        else:
            y = F.conv2d(cur, s["w"].to(cur.device, cdtype), padding=0
                         if kind == "conv1" else 1,
                         groups=cur.shape[1] if kind == "dw3" else 1)
            if s.get("b") is not None:
                y = y + s["b"].to(y.device, cdtype)[None, :, None, None]
            if s.get("slope") is not None:
                y = F.leaky_relu(y, s["slope"])
            if s.get("branch"):
                saved[s["branch"]] = y
            else:
                cur = y
    return cur.permute(0, 2, 3, 1)


def errors(out, ref):
    """max |err|, max |ref| and relative RMS of `out` against `ref`."""
    o, r = out.double(), ref.double()
    return {"max_abs_err": float((o - r).abs().max()),
            "max_abs_ref": float(r.abs().max()),
            "rel_rms": float(torch.sqrt(torch.mean((o - r) ** 2))
                             / torch.sqrt(torch.mean(r ** 2)).clamp_min(1e-30))}


def run(mode="bf16", c=48, reps=4):
    """Both variants at one configuration on the card: errors against the
    plain version, device times, and the kernel's launches per call."""
    set_fp32_parity()
    cdtype = CDTYPES[mode]
    x, specs = make_chain(c, reps)
    chain = ConvChain(specs, c, cdtype, x.device)
    ref = conv_chain_plain(x, specs, cdtype)
    result = {"shape": list(x.shape), "reps": reps, "mode": mode,
              "slope": SLOPE, "tile": list(chain.tile),
              "slots_in_shared_memory": chain.in_shared_memory,
              "executed_gflop": chain.executed_flops(*x.shape[:3]) / 1e9,
              "plain_version_ms": time_ms(
                  lambda: conv_chain_plain(x, specs, cdtype), 5, 1)}
    for name, fn in (("plain", lambda: library_chain(x, specs, cdtype)),
                     ("chain", lambda: chain(x))):
        n0 = conv_chain.launches
        out = fn()
        result[name] = {**errors(out, ref),
                        "launches_per_call": conv_chain.launches - n0,
                        "ms": time_ms(fn, ITERS)}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="bf16", choices=sorted(CDTYPES))
    ap.add_argument("--c", type=int, default=48)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    require_cuda()
    result = run(args.mode, args.c, args.reps)
    result["card"] = card()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
