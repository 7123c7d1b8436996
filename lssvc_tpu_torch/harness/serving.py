"""Encode-only GOP serving loop with pipelined host entropy coding (the
JAX package's `harness/serving.py`).

The evaluation harness decodes every frame right after encoding it
(`run_test` with `write_stream`); an encoder deployment does not.  This
loop writes the bitstreams of an I/P GOP sequence with the P-frames'
host rANS on a worker thread (`models/pipeline.py`) and the decoded-picture
buffer on the device end to end: the closed-loop encoders hand on the DPB
a decoder rebuilds, so no verification decode is on the critical path.
The DPB clamp between frames is the runner's, so the files are byte for
byte those of `run_test` with `write_stream` on the same device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..models import pipeline
from ..models.intra_ss_stream import compress_stream
from ..utils.host import clamp_dpb
from ..utils.io import YUVReader
from ..utils.padding import get_interlayer_padding
from .runner import RATIO_FACTORS, layer_inputs


def read_frames(yuv_path, height, width, ratio, frame_num, device):
    """The first `frame_num` frames of an 8-bit 4:2:0 file as `run_test`
    codes them: [(x_bl, x_el), ...] padded NHWC on `device`, and the
    padded (height, width) of the BL and of the EL."""
    pad = get_interlayer_padding(H_HR=height, W_HR=width,
                                 ratio=RATIO_FACTORS[ratio])
    reader = YUVReader(yuv_path, width, height)
    try:
        frames = [layer_inputs(*reader.read_one_frame(), pad, device)[:2]
                  for _ in range(frame_num)]
    finally:
        reader.close()
    return frames, tuple(pad["LR_padded_size"]), tuple(pad["HR_padded_size"])


def encode_gop(i_frame_net, video_net, frames_bl, frames_el, gop_size,
               bl_paths, el_paths, hw_bl, hw_el):
    """Encode a sequence of (BL, EL) frame pairs to per-frame .bin files.

    i_frame_net: an IntraSS, video_net: an LSSVCExtend, both with their
    tables built (`update`) and `set_scale_information` applied; hw_bl /
    hw_el: the padded (height, width) of the layers.  I-frames code inline
    through `intra_ss_stream.compress_stream` after the pending P-frames'
    host work has drained (so two frames' coder state never interleave).
    Returns (final DPB on the device, [(bits_bl, bits_el), ...])."""
    n = len(frames_bl)
    if not len(frames_el) == len(bl_paths) == len(el_paths) == n:
        raise ValueError("one EL frame and one BL and EL path per BL frame")
    bits = [None] * n
    dpb = None
    with ThreadPoolExecutor(max_workers=1) as pool:  # in-order host coding
        pending = {}
        for t in range(n):
            if t % gop_size == 0:
                for u in sorted(pending):
                    bits[u] = pending[u].result()
                pending.clear()
                res = compress_stream(i_frame_net, frames_bl[t], frames_el[t],
                                      bl_paths[t], el_paths[t], *hw_bl,
                                      *hw_el)
                bits[t] = (res["bit_bl"], res["bit_el"])
                dpb = clamp_dpb({
                    "ref_frame_bl": res["x_hat_bl"],
                    "ref_frame_el": res["x_hat_el"],
                    "ref_feature_bl": None,
                    "ref_feature_el": res["feature_el"]})
            else:
                dpb, pending[t] = pipeline.submit_p_frame(
                    video_net, frames_bl[t], frames_el[t], dpb, bl_paths[t],
                    el_paths[t], pool)
        for u in sorted(pending):
            bits[u] = pending[u].result()
    return dpb, bits
