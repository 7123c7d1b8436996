"""The port's collectives over a torch.distributed process group.

NCCL takes CUDA tensors; `gloo` takes CPU tensors (the tests' ranks, and
two ranks sharing one card, which NCCL refuses).  On a `gloo` group a CUDA
tensor is staged through the host explicitly, chosen by the group's
backend: `staged(t, group)`.  Bytes travel as uint8 in `all_gather`, which
every backend takes whatever the dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def staged(t, group) -> bool:
    """Whether `t` crosses `group` through the host (a CUDA tensor on
    gloo)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t, group) -> list:
    """Every rank's `t` (equal shapes on every rank), in rank order, on
    `t`'s device."""
    t = t.contiguous()
    src = t.cpu() if staged(t, group) else t
    flat = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return [p.view(t.dtype).reshape(t.shape).to(t.device) for p in parts]


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """`t` reduced over the ranks of `group`, as a new tensor on `t`'s
    device."""
    t = t.contiguous()
    buf = t.cpu() if staged(t, group) else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def broadcast_(t, group, src: int = 0):
    """`t` overwritten with rank `src`'s (a global rank), in place."""
    if staged(t, group):
        buf = t.cpu()
        dist.broadcast(buf, src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src, group=group)
    return t
