"""Multi-rank serving: N concurrent video streams, one per rank (the JAX
package's `parallel/serve.py`).

Each rank runs the whole two-layer codec on its own stream; the frame
loop needs no collective (the codec has none), and the stream's DPB stays
on the rank's device between frames.  The per-stream bits are gathered
once a frame, so every rank returns the (B, 2) table of (bit_bl, bit_el).
"""

from __future__ import annotations

import torch

from ..models import lssvc as lssvc_model
from ..ops.nn import Mode, precision_scope
from ..utils import collectives
from .mesh import group_or_world, world_of


def make_serving_step(group=None, shape_hr=(1152, 1920), scale_factor=2.0,
                      pad_size=(0, 0, 0, 0), precision: str = "fp32",
                      od_offset_cap=None):
    """step(params, x_bl, x_el, dpb) -> (dpb', bits): the arguments are
    this rank's stream (batch 1, the model's DPB keys), `dpb'` its next
    DPB and `bits` the (B, 2) per-stream (bit_bl, bit_el) of every rank's
    stream, B the world size.  Frames of one stream stay serial (the
    codec's dependency); streams run in parallel."""
    mode = Mode(precision)

    def step(params, x_bl, x_el, dpb):
        with torch.no_grad(), precision_scope(mode):
            out = lssvc_model.forward_one_frame(
                params, x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
                dpb["ref_feature_bl"], dpb["ref_feature_el"], shape_hr,
                scale_factor, pad_size, od_offset_cap)
        bits = torch.stack([out["bit_bl"], out["bit_el"]]).float()
        if world_of(group)[1] == 1:
            return out["dpb"], bits[None]
        return out["dpb"], torch.stack(
            collectives.all_gather(bits, group_or_world(group)))

    return step


def serve_streams(params, frames_bl, frames_el, dpb0, group=None,
                  shape_hr=(1152, 1920), scale_factor=2.0,
                  pad_size=(0, 0, 0, 0), precision: str = "fp32",
                  od_offset_cap=None):
    """Drive T frames of B concurrent streams, stream b on rank b: returns
    (this rank's final DPB, (T, B, 2) per-frame and per-stream bits).
    frames_*: (T, B, H, W, C), the same on every rank (each takes its
    stream's); dpb0: each DPB key (B, H, W, C)."""
    _, world = world_of(group)
    b = frames_bl.shape[1]
    assert b == world, (
        f"serve_streams: {b} streams on a {world}-device mesh — "
        "per-stream bits require exactly one stream per device (the shard "
        "body sums bits over its whole local batch)")
    rank, _ = world_of(group)
    step = make_serving_step(group, shape_hr, scale_factor, pad_size,
                             precision, od_offset_cap)
    mine = slice(rank, rank + 1)
    dpb = {k: v[mine] for k, v in dpb0.items()}
    all_bits = []
    for t in range(frames_bl.shape[0]):
        dpb, bits = step(params, frames_bl[t, mine], frames_el[t, mine], dpb)
        all_bits.append(bits)
    return dpb, torch.stack(all_bits)
