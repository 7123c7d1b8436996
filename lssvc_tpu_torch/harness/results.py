"""Per-sequence metric aggregation and the result-JSON schema (a copy of
the JAX package's `harness/results.py`).

The exact key set the reference writes per layer (`test.py:407-537`,
whitelist `src/utils/common.py:25-37`), so that downstream BD-rate tools
read either implementation's JSONs.
"""

from __future__ import annotations

import numpy as np

RESULT_KEYS = [
    "i_frame_num", "p_frame_num",
    "ave_i_frame_bpp", "ave_i_frame_psnr", "ave_i_frame_rgb_psnr",
    "ave_i_frame_msssim", "ave_i_frame_rgb_msssim", "ave_i_frame_YUV_psnr",
    "ave_p_frame_bpp", "ave_p_frame_psnr", "ave_p_frame_rgb_psnr",
    "ave_p_frame_msssim", "ave_p_frame_rgb_msssim", "ave_p_frame_YUV_psnr",
    "ave_all_frame_bpp", "ave_all_frame_psnr", "ave_all_frame_rgb_psnr",
    "ave_all_frame_msssim", "ave_all_frame_rgb_msssim", "ave_all_frame_YUV_psnr",
    "encoding_time", "decoding_time",
]


def filter_dict(result: dict) -> dict:
    """Keep only the published result keys (`common.py:25-37`), and
    `decoding_profiling` (per-stage decode seconds, under
    `--decoding_profiling`) where present, as the JAX package does."""
    keep = {k: v for k, v in result.items() if k in RESULT_KEYS}
    if "decoding_profiling" in result:
        keep["decoding_profiling"] = result["decoding_profiling"]
    return keep


class FrameMetrics:
    """Per-frame quality/bit record for one layer."""

    __slots__ = ("bit", "yuv_psnr", "rgb_psnr", "y_psnr", "u_psnr", "v_psnr",
                 "msssim", "rgb_msssim")

    def __init__(self, bit, yuv_psnr, rgb_psnr, y_psnr, u_psnr, v_psnr,
                 msssim, rgb_msssim):
        self.bit = bit
        self.yuv_psnr = yuv_psnr
        self.rgb_psnr = rgb_psnr
        self.y_psnr = y_psnr
        self.u_psnr = u_psnr
        self.v_psnr = v_psnr
        self.msssim = msssim
        self.rgb_msssim = rgb_msssim


def _mean(vals):
    return float(np.mean(vals)) if len(vals) else 0.0


def aggregate_layer_log(frames, frame_types, pixel_num, test_time,
                        encoding_time_total, decoding_time_total,
                        include_yuv_list=True, bits_override=None) -> dict:
    """Aggregate a layer's per-frame metrics into the reference's log dict.

    `bits_override`: per-frame bit list to use instead of frames[i].bit
    (the FL log sums BL+EL bits while reporting EL quality).
    """
    n = len(frames)
    types = np.asarray(frame_types)
    bits = np.asarray(bits_override if bits_override is not None
                      else [f.bit for f in frames], dtype=np.float64)
    i_sel = types == 0
    p_sel = ~i_sel
    n_i = int(i_sel.sum())
    n_p = int(p_sel.sum())

    def sel_mean(vals, sel):
        vals = np.asarray(vals, dtype=np.float64)
        return float(vals[sel].mean()) if sel.any() else 0.0

    yuv = [f.yuv_psnr for f in frames]
    rgb = [f.rgb_psnr for f in frames]
    yp = [f.y_psnr for f in frames]
    up = [f.u_psnr for f in frames]
    vp = [f.v_psnr for f in frames]
    ms = [f.msssim for f in frames]
    rms = [f.rgb_msssim for f in frames]

    log = {
        "frame_pixel_num": pixel_num,
        "i_frame_num": n_i,
        "p_frame_num": n_p,
        "ave_i_frame_bpp": float(bits[i_sel].sum() / max(n_i, 1) / pixel_num),
        "ave_i_frame_psnr": sel_mean(yuv, i_sel),
        "ave_i_frame_rgb_psnr": sel_mean(rgb, i_sel),
        "ave_i_frame_msssim": sel_mean(ms, i_sel),
        "ave_i_frame_rgb_msssim": sel_mean(rms, i_sel),
        "frame_bpp": list(bits / pixel_num),
        "frame_type": list(int(t) for t in types),
        "test_time": test_time,
        "encoding_time": encoding_time_total / max(n_p, 1),
        "decoding_time": decoding_time_total / max(n_p, 1),
        "ave_p_frame_bpp": float(bits[p_sel].sum() / max(n_p, 1) / pixel_num)
        if n_p else 0,
        "ave_p_frame_psnr": sel_mean(yuv, p_sel),
        "ave_p_frame_rgb_psnr": sel_mean(rgb, p_sel),
        "ave_p_frame_msssim": sel_mean(ms, p_sel),
        "ave_p_frame_rgb_msssim": sel_mean(rms, p_sel),
        "ave_all_frame_bpp": float(bits.sum() / (n * pixel_num)),
        "ave_all_frame_psnr": _mean(yuv),
        "ave_all_frame_rgb_psnr": _mean(rgb),
        "ave_all_frame_msssim": _mean(ms),
        "ave_all_frame_rgb_msssim": _mean(rms),
    }
    if include_yuv_list:
        log["ave_i_frame_YUV_psnr"] = [sel_mean(yp, i_sel),
                                       sel_mean(up, i_sel),
                                       sel_mean(vp, i_sel)]
        log["ave_p_frame_YUV_psnr"] = ([sel_mean(yp, p_sel),
                                        sel_mean(up, p_sel),
                                        sel_mean(vp, p_sel)]
                                       if n_p else [0, 0, 0])
        log["ave_all_frame_YUV_psnr"] = [_mean(yp), _mean(up), _mean(vp)]
    return log
