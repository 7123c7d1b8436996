"""What the two frame-wide routes to row-invariant convs would cost the
1080p P-frame, the routes `ops/strips.py` does not take.

    python -m lssvc_tpu_torch.tools.conv_routes_cost [--frames 4]
        [--modes fp32 bf16] [--routes chunks native] [--size 1152x1920]
        [--device cuda]

A strip computes the frame's bits only if each conv of its rows is summed
as the frame's are.  `ops/strips.py` picks, for each conv shape, a strip
route that a probe finds to give the frame's bits; these two routes would
instead change every conv of the frame, so that any strip gives its bits:
  chunks  every conv's output rows cut into chunks of one height (G/4
          where 4 divides the output height G, else G/2, else G), aligned
          to global rows, each its own cuDNN call of one shape: its input
          rows and halo, zero rows past the frame materialised, no H
          padding (middle chunks are views of the input, the outputs are
          concatenated);
  native  one algorithm for every shape: cuDNN off, so that PyTorch runs
          its own convolutions (im2col and a GEMM).
The chain of `lssvc_tpu_torch.bench` runs with a route and without it:
plain, route, route, plain per mode.  One JSON line: the convs of one
frame (calls, bytes read and written), each run's s/frame and peak GiB,
each mode's ratio of the means, and for each route whether a strip's rows
of SpyNet's 7x7 64 -> 32 at the BL's 1/8 level (1x72x120x64, the second
of two 36-row strips) are the frame's bits, and their max |difference|.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from .. import bench
from ..ops import nn
from .timing import card


def chunk_rows(g_out: int) -> int:
    """Output rows of a chunk of a level of `g_out` rows."""
    for n in (4, 2):
        if g_out % n == 0:
            return g_out // n
    return g_out


def chunked_conv2d(x, w, b, stride, padding, groups, conv=nn._conv2d):
    """`conv` (an NHWC conv taking (ph, pw) or ((top, bottom), (left,
    right)) padding) in chunks of `chunk_rows` output rows."""
    ph, pw = padding
    pt, pb = (ph, ph) if isinstance(ph, int) else ph
    pl, pr = (pw, pw) if isinstance(pw, int) else pw
    kh, sh = w.shape[2], stride if isinstance(stride, int) else stride[0]
    g = x.shape[1]
    g_out = (g + pt + pb - kh) // sh + 1
    c = chunk_rows(g_out)
    parts = []
    for o0 in range(0, g_out, c):
        a, e = sh * o0 - pt, sh * (o0 + c - 1) - pt + kh
        rows = x[:, max(a, 0):min(e, g)]
        if a < 0 or e > g:
            rows = F.pad(rows, (0, 0, 0, 0, max(-a, 0), max(e - g, 0)))
        parts.append(conv(rows, w, b, stride, (0, (pl, pr)), groups))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


@contextlib.contextmanager
def route(name):
    """The port's convs through route `name` ("plain": as they are)."""
    real, enabled = nn._conv2d, torch.backends.cudnn.enabled
    if name == "chunks":
        nn._conv2d = chunked_conv2d
    elif name == "native":
        torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        nn._conv2d, torch.backends.cudnn.enabled = real, enabled


def strip_rows(device, name):
    """(bit-equal?, max |difference|) of the second 36-row strip's rows of
    SpyNet's 7x7 64 -> 32 at 1x72x120x64 in fp32, computed from its rows
    and halo, against the frame's conv, through route `name`."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, 72, 120, 64), generator=gen, device=device)
    w = torch.randn((32, 64, 7, 7), generator=gen, device=device) / 56
    with route(name), nn.precision_scope(nn.Mode("fp32")):
        frame = nn._conv2d(x, w, None, 1, (3, 3), 1)[:, 36:]
        rows = F.pad(x[:, 33:], (0, 0, 0, 0, 0, 3)).contiguous()
        strip = nn._conv2d(rows, w, None, 1, (0, 3), 1)
    return bool(torch.equal(frame, strip)), float((frame - strip).abs().max())


def conv_bytes(mode, size, device):
    """(calls, input bytes, output bytes) of the convs of one P-frame of the
    chain (`F.conv2d` as `ops.nn` calls it)."""
    tally = [0, 0, 0]
    real = nn.F.conv2d

    def counted(x, w, *args, **kwargs):
        y = real(x, w, *args, **kwargs)
        tally[0] += 1
        tally[1] += x.numel() * x.element_size()
        tally[2] += y.numel() * y.element_size()
        return y

    nn.F.conv2d = counted
    try:
        bench.bench_chain(el_hw=size, k=1, mode=mode, device=device,
                          readings=0)
    except RuntimeError:  # no readings asked for: the warm-up frame ran
        pass
    finally:
        nn.F.conv2d = real
    return tuple(tally)


def run(modes, routes, frames, size, device):
    out = {"strip_rows": {name: strip_rows(device, name)
                          for name in ("plain", *routes)}, "modes": {}}
    for mode in modes:
        calls, read, written = conv_bytes(mode, size, device)
        entry = out["modes"][mode] = {"conv_calls": calls,
                                      "conv_in_bytes": read,
                                      "conv_out_bytes": written}
        for name in routes:
            rows = []
            for taken in (False, True, True, False):
                with route(name if taken else "plain"):
                    res = bench.bench_chain(el_hw=size, k=frames, mode=mode,
                                            device=device)
                rows.append({"route": name if taken else "plain",
                             "s_per_frame": res["s_per_frame"],
                             "peak_gib": res["peak_gib"]})
            plain = [r["s_per_frame"] for r in rows if r["route"] == "plain"]
            taken = [r["s_per_frame"] for r in rows if r["route"] == name]
            entry[name] = {"runs": rows, "ratio": sum(taken) / sum(plain)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--modes", nargs="+", default=["fp32", "bf16"])
    ap.add_argument("--routes", nargs="+", default=["chunks", "native"],
                    choices=["chunks", "native"])
    ap.add_argument("--size", default="1152x1920")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x"))
    device = torch.device(args.device)
    print(json.dumps(run(args.modes, args.routes, args.frames, size,
                         device)), flush=True)
    if device.type == "cuda":
        print(card(), flush=True)


if __name__ == "__main__":
    main()
