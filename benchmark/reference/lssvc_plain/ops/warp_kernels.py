"""The warps' plain formulas under the kernels' names (the program's
`ops/warp_kernels.py` launches CUDA kernels; its CPU branch is this).
Under `nn.lower_precision` a warp's source and output are rounded to that
precision, as a kernel that loads and stores it would."""

from __future__ import annotations

import torch

from .nn import lower_values
from .packed import pack_width
from .warp import flow_warp as _flow_warp
from .warp import grouped_warp_plain


def flow_warp(x, flow, packed_out=False):
    out = lower_values(_flow_warp(lower_values(x), flow))
    return pack_width(out, 2) if packed_out else out


def flow_warp_pair(a, b, flow, packed_out=False):
    ca = a.shape[-1]
    out = lower_values(_flow_warp(lower_values(torch.cat([a, b], dim=-1)),
                                  flow))
    if packed_out:
        return pack_width(out, 2)
    return out[..., :ca], out[..., ca:]


def grouped_warp(x, flow_x, flow_y, mask, group_num: int, packed_out=False):
    out = lower_values(grouped_warp_plain(lower_values(x), flow_x, flow_y,
                                          mask, group_num))
    return pack_width(out, 2) if packed_out else out
