"""Where the time of one two-layer P-frame goes on the GPU.

    python -m lssvc_tpu_torch.tools.profile_frame

Builds LSSVC from the port's random init (fp32, offset cap 10 px) at EL
1152x1920 / BL 576x960, runs one warm-up frame, then one frame under
torch.profiler, and prints one JSON line: the frame's wall time, the summed device time of its kernels, the
device's busy share (summed kernel time over wall time; kernels do not
overlap on one stream), the share of the warp kernels, and the 15 top ops
by device time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..models import LSSVC
from ..models.init import init_lssvc
from ..ops import OD_OFFSET_CAP_SERVING

EL_HW, BL_HW = (1152, 1920), (576, 960)
TOP = 15


def _device_us(evt):
    # torch renamed cuda_* timing attributes to device_* in 2.4
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main():
    el, bl = EL_HW, BL_HW
    dev = torch.device("cuda")
    model = LSSVC(init_lssvc(torch.Generator().manual_seed(0)), device=dev,
                  od_offset_cap=OD_OFFSET_CAP_SERVING)
    model.set_scale_information(2.0, el, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    inputs = (uni(*bl, 3), uni(*el, 3), uni(*bl, 3), uni(*el, 3),
              uni(*bl, 64), uni(*el, 48))
    model.forward_one_frame(*inputs)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward_one_frame(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel-level rows: events that ran on the device themselves
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(_device_us(e) for e in rows) / 1e3
    warp_ms = sum(_device_us(e) for e in rows if "warp_kernel" in e.key) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:TOP]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "el": list(el), "bl": list(bl), "precision": "fp32",
        "wall_ms": wall_ms, "device_kernel_ms": total_ms,
        "busy_share": total_ms / wall_ms, "warp_kernel_ms": warp_ms,
        "top": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3,
                 "count": e.count} for e in top]}))


if __name__ == "__main__":
    main()
