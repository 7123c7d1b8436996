"""Operation counts of a frame, from the shapes of its aten calls.

The program's `lssvc_tpu_torch/tools/profile_frame.py` `frame_flops`
(commit 4d8626f) counts one call with `torch.utils.flop_counter`'s
formulas (convolutions and matrix products).  This copy keeps the same
formulas and sorts each count by its first operand's dtype, so that
`mfu` can hold each operation to its own peak (`peaks.BY_DTYPE`).  The
warps are ctypes kernels, not aten calls: they are bound by bytes and
count no operations here.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from . import peaks


class DtypeFlops(TorchDispatchMode):
    """Counts, by operand dtype name, the FLOPs of every aten call that
    `torch.utils.flop_counter` has a formula for, on this thread."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            dtype = next((a.dtype for a in args
                          if isinstance(a, torch.Tensor)), None)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.counts[str(dtype).replace("torch.", "")] += float(flops)
        return out


def seconds_at_peak(counts: dict) -> float:
    """The least seconds the chip could take for these operations, each
    at its own dtype's peak (a dtype with no listed peak at f32's)."""
    return sum(v / peaks.BY_DTYPE.get(k, peaks.FP32_FLOPS)
               for k, v in counts.items())
