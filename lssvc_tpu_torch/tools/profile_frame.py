"""Where the time of one 1080p frame goes on the GPU: a two-layer P-frame,
then a two-layer I-frame.

    python -m lssvc_tpu_torch.tools.profile_frame

Builds LSSVC (offset cap 10 px) and IntraSS (BL 192 channels) from the
port's random init, fp32, at EL 1152x1920 / BL 576x960.  For each frame
type it runs one warm-up frame, one frame with CUDA events around it and
around each convolution, then one frame under torch.profiler, and prints
one JSON line: the frame's convolution and matmul FLOPs (counted from
their shapes by torch.utils.flop_counter), its device span from the
events, its peak memory (the frame's inputs and weights included) and
the 8 convolution shapes whose spans sum the largest, then,
from the profiled frame, its wall time, the summed device time of its
kernels, the device's busy share (summed kernel time over wall time;
kernels do not overlap on one stream), the share of the warp kernels and
the 15 top kernels by device time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from ..models import LSSVC, IntraSS
from ..models.init import init_intra_ss, init_lssvc
from ..ops import OD_OFFSET_CAP_SERVING
from .timing import card, require_cuda

EL_HW, BL_HW = (1152, 1920), (576, 960)
TOP, TOP_CONVS = 15, 8


def _device_us(evt):
    # torch renamed cuda_* timing attributes to device_* in 2.4
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def frame_flops(frame) -> float:
    """Convolution and matmul FLOPs of one call of `frame()`, from their
    shapes."""
    with FlopCounterMode(display=False) as counter:
        frame()
    return float(counter.get_total_flops())


def iframe_flops(el_hw=EL_HW, bl_hw=BL_HW, channel_bl=192) -> dict:
    """FLOPs of one two-layer IntraSS frame, from its conv shapes, counted
    on the meta device (no data, no card): {"bl": IntraNoAR's, "el": the
    enhancement layer's, "total"}."""
    model = IntraSS(init_intra_ss(torch.Generator().manual_seed(0),
                                  channel_bl), device="meta")
    model.set_scale_information(el_hw[0] / bl_hw[0], el_hw, (0, 0, 0, 0))
    x_bl = torch.empty((1, *bl_hw, 3), device="meta")
    x_el = torch.empty((1, *el_hw, 3), device="meta")
    total = frame_flops(lambda: model.forward(x_bl, x_el))
    bl = frame_flops(lambda: model.base_layer_model.forward(x_bl))
    return {"bl": bl, "el": total - bl, "total": total}


def _event():
    return torch.cuda.Event(enable_timing=True)


def conv_spans(frame) -> tuple[float, list[dict]]:
    """One call of `frame()` with CUDA events around it and around every
    F.conv2d it makes, no profiler: the frame's device span in ms, and the
    convolutions whose spans sum the largest, grouped by (input shape,
    weight shape, stride).  A span is the device time from the call's
    first kernel to its last, so it also holds any wait for the host to
    launch them."""
    real, spans = F.conv2d, {}

    def timed(x, w, *args, **kwargs):
        start, end = _event(), _event()
        start.record()
        out = real(x, w, *args, **kwargs)
        end.record()
        key = (tuple(x.shape), tuple(w.shape), kwargs.get("stride", 1))
        spans.setdefault(key, []).append((start, end))
        return out

    first, last = _event(), _event()
    F.conv2d = timed
    try:
        first.record()
        frame()
        last.record()
    finally:
        F.conv2d = real
    torch.cuda.synchronize()
    rows = sorted(((sum(s.elapsed_time(e) for s, e in calls), key,
                    len(calls)) for key, calls in spans.items()),
                  reverse=True)[:TOP_CONVS]
    return first.elapsed_time(last), [
        {"input": list(x), "weight": list(w), "stride": st, "calls": n,
         "ms": ms} for ms, (x, w, st), n in rows]


def breakdown(frame) -> dict:
    """One warm-up call of `frame()`, one with CUDA events (and the peak
    memory of that call), then one under torch.profiler."""
    flops = frame_flops(frame)  # also the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    span_ms, convs = conv_spans(frame)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel-level rows: events that ran on the device themselves
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(_device_us(e) for e in rows) / 1e3
    warp_ms = sum(_device_us(e) for e in rows if "warp_kernel" in e.key) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:TOP]
    return {"wall_ms": wall_ms, "device_kernel_ms": total_ms,
            "busy_share": total_ms / wall_ms, "warp_kernel_ms": warp_ms,
            "tflop": flops / 1e12,
            "top": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3,
                     "count": e.count} for e in top],
            "device_span_ms": span_ms, "peak_mem_gib": peak_gib,
            "top_convs": convs}


def main():
    el, bl = EL_HW, BL_HW
    dev = require_cuda()
    smi = card()
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    video = LSSVC(init_lssvc(torch.Generator().manual_seed(0)), device=dev,
                  od_offset_cap=OD_OFFSET_CAP_SERVING)
    video.set_scale_information(2.0, el, (0, 0, 0, 0))
    inputs = (uni(*bl, 3), uni(*el, 3), uni(*bl, 3), uni(*el, 3),
              uni(*bl, 64), uni(*el, 48))
    p_frame = breakdown(lambda: video.forward_one_frame(*inputs))
    print(json.dumps({"card": smi, "frame": "P (LSSVC.forward_one_frame)",
                      "el": list(el), "bl": list(bl), "precision": "fp32",
                      **p_frame}), flush=True)
    del video, inputs

    intra = IntraSS(init_intra_ss(torch.Generator().manual_seed(0), 192),
                    device=dev)
    intra.set_scale_information(2.0, el, (0, 0, 0, 0))
    x_bl, x_el = uni(*bl, 3), uni(*el, 3)
    i_frame = breakdown(lambda: intra.forward(x_bl, x_el))
    print(json.dumps({"card": smi, "frame": "I (IntraSS.forward)",
                      "el": list(el), "bl": list(bl), "precision": "fp32",
                      **i_frame}), flush=True)


if __name__ == "__main__":
    main()
