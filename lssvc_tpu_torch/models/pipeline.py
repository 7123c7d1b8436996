"""Pipelined two-layer P-frame encoder and overlapped decoder: host rANS
beside device work (the JAX package's `models/pipeline.py`).

The sequential stream path (`LSSVCExtend.encode_decode`) runs each frame
as device work, then host rANS encode, then host rANS decode, so the card
idles during every entropy-coding step.  Here:

  main thread, frame t:   the closed-loop device encode of both layers
                          (`DMCExtend.encode_planes`,
                          `LSSVCExtend.encode_planes`: the symbol planes
                          and the decoder's DPB), the planes' copies into
                          pinned host memory started behind a CUDA event;
  worker thread:          waits for that event, rANS-encodes frame t's
                          planes and writes its two .bin files;
  main thread, frame t+1: starts from the DPB frame t left on the card.

The closed-loop encoders derive every index and means plane from the
decoder's own stage functions, so the DPB handed to frame t+1 is the one
a decoder rebuilds from the stream, and the bins are byte for byte those
of the sequential loop under the runner's DPB clamp.

Every device op stays on the main thread, in the owning model's mode
(`Model.scope`); a worker thread does host rANS, host reshapes and file
writes only.  The two-layer decoder (`lssvc_stream.decode_frame_overlapped`,
which the runner and the decode CLI use too) keeps the same split: the
worker rANS-decodes one layer's planes while the card runs the other
layer's stages; `decode_sequence` chains it over a run of P-frames.

Spans of an encoded P-frame (`utils/spans.py`), on the main thread: the
frame `lssvc.p.encode`; its layers' device encodes `lssvc.p.encode.bl`,
`lssvc.p.encode.el`; the planes' host copies enqueued,
`lssvc.p.encode.d2h`; the one-frame-in-flight wait, `lssvc.wait.pace`;
inside the device encodes, each copy of a constant to the card, after
which the stream synchronises, `lssvc.wait.h2d` (the GDN and clip bounds,
the flow clamp, the checkerboard masks, OffsetDiversity's fusion scatter).
On the worker, carrying the frame's id: `lssvc.p.write`, and inside it
the wait for the planes' copy (`lssvc.wait.d2h`) and each layer's rANS
encode (`lssvc.entropy.encode`).  The decoder's spans: its docstring.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..utils import spans
from ..utils.host import HostCopy, clamp_dpb
from ..utils.stream import decode_p, encode_p, filesize
from . import dmc_stream as ds
from . import lssvc_stream as ls
from .lssvc_stream import decode_frame_overlapped


# --- pipelined encode -------------------------------------------------------

def frame_device(model, x_bl, x_el, dpb):
    """All device work of one two-layer P-frame: (BL planes, EL planes,
    next DPB), through the models' own `encode_planes` (the device halves
    of their `compress`); nothing is read on the host."""
    bl = model.base_layer_model
    with spans.span("lssvc.p.encode.bl"):
        bl_planes, bl_dpb = bl.encode_planes(x_bl, dpb)
    with spans.span("lssvc.p.encode.el"):
        el_planes, el_dpb = model.encode_planes(x_el, dict(
            dpb, texture=bl_dpb["ref_feature_bl"],
            y_hat_bl=bl_dpb["y_hat_bl"], mv_hat_bl=bl_dpb["mv_hat_bl"]))
    next_dpb = {"ref_frame_bl": bl_dpb["ref_frame_bl"],
                "ref_feature_bl": bl_dpb["ref_feature_bl"],
                "ref_frame_el": el_dpb["ref_frame_el"],
                "ref_feature_el": el_dpb["ref_feature_el"]}
    return bl_planes, el_planes, next_dpb


def _host_code_frame(model, planes: HostCopy, bl_path, el_path):
    """The worker's half: rANS-encode both layers' planes once their copy
    has landed, write the two files; returns their bits."""
    with spans.span("lssvc.p.write"):
        bl_planes, el_planes = planes.get()
        encode_p(ds.write_planes(model.base_layer_model._coder, bl_planes),
                 bl_path)
        encode_p(ls.write_planes(model._coder, el_planes), el_path)
        return filesize(bl_path) * 8, filesize(el_path) * 8


def submit_p_frame(model, x_bl, x_el, dpb, bl_path, el_path, pool):
    """One paced pipelined P-frame, the per-frame block of every encode
    loop (`encode_sequence`, `harness.serving.encode_gop`): the device
    encode, the runner's DPB clamp, the planes' host copies started, then
    the wait for this frame's device work (one frame in flight, as the
    JAX package paces, `pipeline.py:105-119`), then the host rANS handed
    to `pool` (`_host_code_frame` as the module holds it at the call,
    carrying the frame's spans).  While the card runs frame t+1, the
    worker codes frame t.  Returns (clamped DPB, future of (bits_bl,
    bits_el))."""
    with spans.frame("lssvc.p.encode"):
        bl_planes, el_planes, dpb = frame_device(model, x_bl, x_el, dpb)
        dpb = clamp_dpb(dpb)
        with spans.span("lssvc.p.encode.d2h"):
            planes = HostCopy((bl_planes, el_planes))
        with spans.span("lssvc.wait.pace"):
            ds._sync(model.device)
        return dpb, pool.submit(spans.carry(_host_code_frame), model,
                                planes, bl_path, el_path)


def encode_sequence(model, frames_bl, frames_el, dpb, bl_paths, el_paths):
    """Encode a run of P-frames with the host rANS on a worker thread.

    model: an LSSVCExtend with its tables built (`update`) and its scale
    set; frames_bl / frames_el: per-frame NHWC tensors on its device; dpb:
    the DPB before the first frame (an I-frame's, or a P-frame's after
    the runner's clamp).  Returns (final DPB, [(bits_bl, bits_el), ...]).
    The files are byte for byte those of the sequential `compress` (or
    `encode_decode`) loop with the runner's clamp."""
    n = len(bl_paths)
    if len(el_paths) != n:
        raise ValueError("one EL path per BL path")
    with ThreadPoolExecutor(max_workers=1) as pool:  # in-order host coding
        futures = []
        for t in range(n):
            dpb, fut = submit_p_frame(model, frames_bl[t], frames_el[t], dpb,
                                      bl_paths[t], el_paths[t], pool)
            futures.append(fut)
        bits = [f.result() for f in futures]
    return dpb, bits


# --- overlapped decode (`lssvc_stream.decode_frame_overlapped`) -----------

def decode_sequence(model, bl_paths, el_paths, dpb, h_bl, w_bl, h_el, w_el):
    """Decode a run of P-frames with the overlapped frame decoder and the
    runner's clamp between frames.  model: an LSSVCExtend with its tables
    built and its scale set.  Returns the final DPB.  The next frame's
    file reads and first factorized plane run on the host while the card
    finishes the frame before; its first index plane's copy then waits
    for it, so at most one frame is in flight."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        for pb, pe in zip(bl_paths, el_paths):
            out = decode_frame_overlapped(model, decode_p(pb), decode_p(pe),
                                          h_bl, w_bl, h_el, w_el, dpb, pool)
            dpb = clamp_dpb(out["dpb"])
    return dpb
