"""The int8 convolution on the GPU: the conv-stack microbench of the JAX
package's `tools/int8_bench.py`, and the kernel at two sites of the int8
P-frame.

    python -m lssvc_tpu_torch.tools.int8_bench

Stack variants, at the JAX tool's shape (the width-packed full-res EL
domain, 1x1152x960x96, four 3x3 layers with a ReLU, weights normal x 0.05
and input normal from numpy seed 0; s8 copies x512 and x32):

  bf16        F.conv2d per layer, bf16 in and out (cuDNN; today's
              bf16_packed serving path)
  int8_conv   the int8_conv kernel, s8 in, s32 out, then the f32 requant
              to s8 (scale 2e-3, ReLU, round, clamp) in PyTorch
  int8_fx     the kernel's s32, then the all-integer `requant_fixed`
  int8_noreq  the kernel's s32 shifted right by 9 into s8
  int8_mm     a library yardstick, not a path of the port: each layer as
              nine shifted `torch._int_mm` calls (one a tap) summed in s32

Sites (`SITES`): the int8 path's call, a bf16 input quantized as it loads
and the bf16 epilogue, at the packed 3x3 96 -> 96 stack conv and at
SpyNet's packed 7x3 `conv2` of the EL's full-resolution level, beside its
plain version (`int8_conv2d_plain` on the card), cuDNN's bf16 conv of the
same packed shape (the path the int8 site replaces, not the same
function), the taps-call `torch._int_mm` yardstick, and its two bounds:
bytes (the bf16 input read once, the bf16 output written once, the s8
kernel and the f32 epilogue read once) over 3.35 TB/s, and operations (2 x
the MACs) over 1,979 int8 TOP/s (NVIDIA's H100 SXM data sheet).  Times are
CUDA-event means (`tools/timing.py`); one JSON line with the card's name
and power limit.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8 import (Int8Weight, fixed_point_multiplier, int8_conv2d,
                        int8_conv2d_plain, requant_fixed)
from .timing import card, require_cuda, time_ms

H, WP, C = 1152, 960, 96  # packed full-res EL domain (p=2, 1920/2, 2*48)
LAYERS = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# (n, h, w, cin, cout, kh, kw, padding) of two sites of the 1080p int8 frame
SITES = {
    "packed_3x3_96": (1, 1152, 960, 96, 96, 3, 3, ((1, 1), (1, 1))),
    "spynet_el_conv2": (1, 1152, 480, 128, 256, 7, 3, ((3, 3), (1, 1))),
}


def _requant(acc):
    # per-tensor scale + ReLU + clamp back to s8 (the JAX tool's)
    y = torch.clamp_min(acc, 0).float() * 2e-3
    return torch.round(y).clamp_(0, 127).to(torch.int8)


def int_mm_conv(x8, w8, pad):
    """A conv as one `torch._int_mm` a tap on shifted views (the library
    yardstick): x8 (1, H, W, Cin) s8, w8 OIHW s8, stride 1."""
    n, h, w, cin = x8.shape
    cout, _, kh, kw = w8.shape
    (pt, pb), (pl, pr) = pad
    xp = F.pad(x8, (0, 0, pl, pr, pt, pb))
    acc = None
    for ky in range(kh):
        for kx in range(kw):
            seg = xp[:, ky:ky + h, kx:kx + w].reshape(n * h * w, cin)
            part = torch._int_mm(seg, w8[:, :, ky, kx].t().contiguous())
            acc = part if acc is None else acc + part
    return acc.view(n, h, w, cout)


def stack_variants(dev):
    """ms per four-layer stack of each variant."""
    rng = np.random.default_rng(SEED)
    ws = [rng.standard_normal((C, C, 3, 3)).astype(np.float32) * 0.05
          for _ in range(LAYERS)]
    w16 = [torch.from_numpy(w).to(dev, torch.bfloat16) for w in ws]
    w8 = [torch.from_numpy(np.clip(np.round(
        w16[i].float().cpu().numpy() * 512), -127, 127).astype(np.int8))
        .to(dev) for i in range(LAYERS)]
    kern = [Int8Weight(w) for w in w8]
    x16 = torch.from_numpy(rng.standard_normal((1, H, WP, C))
                           .astype(np.float32)).to(dev, torch.bfloat16)
    x8 = torch.round(x16.float() * 32).clamp_(-127, 127).to(torch.int8)
    fx = [fixed_point_multiplier(1 / 32, np.full((C,), 2e-3 * 32), 1.0,
                                 w_q=w.cpu()) for w in w8]
    pad = ((1, 1), (1, 1))

    def bf16():
        x = x16.permute(0, 3, 1, 2)
        for w in w16:
            x = F.relu(F.conv2d(x, w, padding=1))
        return x

    def int8_conv():
        x = x8
        for k in kern:
            x = _requant(int8_conv2d(x, k, 1, pad))
        return x

    def int8_fx():
        x = x8
        for k, (m, post, ash) in zip(kern, fx):
            x = requant_fixed(int8_conv2d(x, k, 1, pad), m, post, ash,
                              relu=True)
        return x

    def int8_noreq():
        x = x8
        for k in kern:
            x = (int8_conv2d(x, k, 1, pad) >> 9).to(torch.int8)
        return x

    def int8_mm():
        x = x8
        for w in w8:
            x = _requant(int_mm_conv(x, w, pad))
        return x

    return {name: time_ms(fn, iters=10) for name, fn in (
        ("bf16", bf16), ("int8_conv", int8_conv), ("int8_fx", int8_fx),
        ("int8_noreq", int8_noreq), ("int8_mm", int8_mm))}


def site_cost(n, h, w, cin, cout, kh, kw, pad):
    """(bytes, operations) of the site's call: bf16 in and out, s8 kernel,
    f32 multiplier and bias; 2 x MACs (stride 1)."""
    (pt, pb), (pl, pr) = pad
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    nbytes = (2 * n * h * w * cin + 2 * n * ho * wo * cout
              + cout * cin * kh * kw + 8 * cout)
    return nbytes, 2 * n * ho * wo * cout * cin * kh * kw


def site_inputs(n, h, w, cin, cout, kh, kw, pad, dev, seed=1):
    """A bf16 input, an s8 kernel with its epilogue, and the input scale."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, cin, kh, kw))
                          .astype(np.int8)).to(dev)
    mult = torch.from_numpy(rng.uniform(1e-5, 1e-4, cout)
                            .astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)) \
        .to(dev)
    return x, Int8Weight(w8, mult, bias), 0.03


def site_times(name, dev):
    """The kernel at a site against its plain version (bit for bit), and
    the times and bounds of `SITES[name]`."""
    n, h, w, cin, cout, kh, kw, pad = SITES[name]
    x, kern, s_in = site_inputs(*SITES[name], dev)
    out = int8_conv2d(x, kern, 1, pad, s_in=s_in)
    ref = int8_conv2d_plain(x, kern, 1, pad, s_in=s_in)
    err = float((out.float() - ref.float()).abs().max())
    nbytes, ops = site_cost(*SITES[name])
    w16 = kern.w_q.to(torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)
    (pt, _), (pl, _) = pad
    x8 = torch.round(x.float() / s_in).clamp_(-127, 127).to(torch.int8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    return {
        "site": name, "shape": [n, h, w, cin], "cout": cout,
        "kernel": [kh, kw], "padding": pad, "max_abs_err": err,
        "ms": time_ms(lambda: int8_conv2d(x, kern, 1, pad, s_in=s_in),
                      iters=20),
        "plain_ms": time_ms(lambda: int8_conv2d_plain(x, kern, 1, pad,
                                                      s_in=s_in),
                            iters=3, warmup=1),
        "cudnn_bf16_ms": time_ms(lambda: F.conv2d(x_nchw, w16,
                                                  padding=(pt, pl)),
                                 iters=20),
        "int_mm_ms": time_ms(lambda: int_mm_conv(x8, kern.w_q, pad),
                             iters=5),
        "int_mm_calls": kh * kw,
        "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main():
    dev = require_cuda()
    stack = stack_variants(dev)
    for name, ms in stack.items():
        print(f"{name:12s} {ms:8.3f} ms  ({LAYERS} layers, {H}x{WP}x{C})"
              + ("  [9 torch._int_mm calls a layer]" if name == "int8_mm"
                 else ""), flush=True)
    sites = [site_times(name, dev) for name in SITES]
    line = {"int8_bench": {"stack_ms": stack, "layers": LAYERS,
                           "shape": [1, H, WP, C]},
            "sites": sites, "card": card()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
