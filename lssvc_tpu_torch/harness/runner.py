"""The per-sequence evaluation loop over GOPs (the JAX package's
`harness/runner.py:29-242`), with estimated bits or, under `write_stream`,
real bitstreams.

Per frame: read the EL YUV -> RGB -> pad -> MATLAB-bicubic downsample to
the BL -> I- or P-frame coding on the device -> metrics on the host.  The
decoded-picture buffer (DPB) stays on the device between frames.  With
`write_stream`, each frame writes `<bin_folder>/<ratio>/{BL,EL}/<i>.bin`
through the models' `encode_decode`, which decodes the files again: the
bits are the files' sizes and the DPB is the decoder's.

With the task's `save_decoded_frame`, `save_decoded_mv`, `save_warp_frame`
or `save_decoded_context`, each frame's artifacts go to PNGs, as the JAX
package writes them (`harness/runner.py:245-291`):
`<decoded_frame_folder>/<ratio>/{BL,EL}/<i>.png` (the decoded pictures),
and for P-frames `<decoded_mv_folder>/<ratio>/<i>.png` (the EL motion,
Middlebury colours), `<warp_frame_folder>/<ratio>/<i>.png` (the EL warped
reference) and `<decoded_context_folder>/<ratio>/<i>.png` (the channel
mean of the EL context c1, min-max normalised).

Host metrics run one frame behind the device: right after frame i is
enqueued, its reconstructions and bit counts are copied to pinned host
buffers (non-blocking, behind a CUDA event), so that frame i's metrics,
computed after frame i+1 is enqueued, wait for that event only and overlap
frame i+1's device work.  (A plain `.cpu()` of frame i's output at that
point would wait for frame i+1 too: one stream runs in order.)  The BL
reference's `.cpu()` each frame, needed for its YUV planes, is a sync
point, as it is in the JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops import pad_nhwc
from ..utils.color import rgb_to_ycbcr420, ycbcr420_to_rgb
from ..utils import host
from ..utils.flow_vis import flow_to_image
from ..utils.io import YUVReader
from ..utils.metrics import calc_msssim, mse_to_psnr
from ..utils.msssim_rgb import ms_ssim_rgb
from ..utils.padding import get_interlayer_padding, inverse_padding_size
from ..utils.png import write_png
from ..utils.resize import imresize
from .results import FrameMetrics, aggregate_layer_log

RATIO_FACTORS = {"x1": 1.0, "x1_5": 1.5, "x2": 2.0, "x3": 3.0, "x4": 4.0}
# the artifacts: the task's "save_<a>" turns one on, "<a>_folder" is where
# it goes (the CLI's --save_<a> and --<a>_path)
ARTIFACTS = ("decoded_frame", "decoded_mv", "warp_frame", "decoded_context")


def _to_device_nhwc(rgb_chw: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(rgb_chw[None].transpose(0, 2, 3, 1))).to(device)


def layer_inputs(y_el, uv_el, pad_info, device):
    """One frame's coder inputs, as the reference's `test.py` makes them
    from the EL's YUV planes: (x_bl, x_el, rgb_el), the EL RGB padded and
    the BL by MATLAB bicubic to its padded size, clamped, both NHWC on
    `device`; rgb_el the EL's CHW RGB on the host."""
    rgb_el = ycbcr420_to_rgb(y_el, uv_el)
    x_el = pad_nhwc(_to_device_nhwc(rgb_el, device), pad_info["P_HR"])
    x_bl = torch.clamp(imresize(x_el.permute(0, 3, 1, 2),
                                sizes=tuple(pad_info["LR_padded_size"])),
                       0, 1).permute(0, 2, 3, 1).contiguous()
    return x_bl, x_el, rgb_el


def _png_8bit(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)


def save_artifacts(args_dict, ratio, frame_idx, out):
    """The PNGs of one frame (module docstring) from its host arrays:
    x_hat_bl / x_hat_el / warp_frame CHW in [0, 1], mv (H, W, 2), context
    (H, W), the last three for P-frames only."""
    def folder(artifact, *sub):
        path = os.path.join(args_dict[f"{artifact}_folder"], ratio, *sub)
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, f"{frame_idx}.png")

    if args_dict.get("save_decoded_frame"):
        for tag in ("BL", "EL"):
            write_png(folder("decoded_frame", tag),
                      _png_8bit(out[f"x_hat_{tag.lower()}"].transpose(1, 2, 0)))
    if args_dict.get("save_decoded_mv") and "mv" in out:
        write_png(folder("decoded_mv"), flow_to_image(out["mv"]))
    if args_dict.get("save_warp_frame") and "warp_frame" in out:
        write_png(folder("warp_frame"),
                  _png_8bit(out["warp_frame"].transpose(1, 2, 0)))
    if args_dict.get("save_decoded_context") and "context" in out:
        ctx = out["context"]
        lo, hi = float(ctx.min()), float(ctx.max())
        norm = (ctx - lo) / (hi - lo) if hi > lo else np.zeros_like(ctx)
        write_png(folder("decoded_context"), _png_8bit(norm))


def _psnr_rgb(a: np.ndarray, b: np.ndarray) -> float:
    return mse_to_psnr(float(np.mean((a - b) ** 2)), 1)


def _layer_metrics(bit, rgb_ref, y_ref, u_ref, v_ref, x_hat_chw, win_size):
    rgb_psnr = _psnr_rgb(rgb_ref, x_hat_chw)
    rgb_ms = ms_ssim_rgb(rgb_ref, x_hat_chw, win_size=win_size, data_range=1)
    y_rec, uv_rec = rgb_to_ycbcr420(x_hat_chw)
    y_rec = y_rec[0]
    u_rec, v_rec = uv_rec[0], uv_rec[1]
    y_psnr = mse_to_psnr(float(np.mean((y_rec - y_ref) ** 2)), 1)
    u_psnr = mse_to_psnr(float(np.mean((u_rec - u_ref) ** 2)), 1)
    v_psnr = mse_to_psnr(float(np.mean((v_rec - v_ref) ** 2)), 1)
    yuv_psnr = (6 * y_psnr + u_psnr + v_psnr) / 8
    msssim = (6 * calc_msssim(y_ref, y_rec, data_range=1)
              + calc_msssim(u_ref, u_rec, data_range=1)
              + calc_msssim(v_ref, v_rec, data_range=1)) / 8
    return FrameMetrics(bit, yuv_psnr, rgb_psnr, y_psnr, u_psnr, v_psnr,
                        msssim, rgb_ms)


class HostCopy(host.HostCopy):
    """One frame's outputs (a dict of tensors) on their way to the host:
    the copies of CUDA tensors into pinned buffers are enqueued at once,
    behind an event; `get()` waits for that event only."""

    def get(self) -> dict:
        """name -> numpy array (a bf16 model's pictures as f32, exactly);
        images as CHW (batch 0)."""
        arrays = {k: v.float().numpy() for k, v in super().get().items()}
        return {k: (a[0].transpose(2, 0, 1) if a.ndim == 4 else a)
                for k, a in arrays.items()}


def run_test(video_net, i_frame_net, args_dict):
    """Code one (sequence, ratio) task.  Returns (log_BL, log_EL, log_FL)
    dicts in the reference's schema.  The models run on their own device
    (`i_frame_net.device`); `video_net` is None for an all-intra run.  With
    `write_stream`, the models are `IntraSS` and `LSSVCExtend` with their
    tables built (`update`), and `bin_folder` names where the bins go.
    With `intra_rdo`, every I-frame codes its BL from latents refined by
    latent RDO with the options `intra_rdo_opt` (`models/rdo.py`)."""
    device = i_frame_net.device
    frame_num = args_dict["frame_num"]
    gop_size = args_dict["gop_size"]
    verbose = int(args_dict.get("verbose", 0))
    write_stream = bool(args_dict.get("write_stream"))
    ratio = args_dict["ratio"]
    scale_factor = RATIO_FACTORS[ratio]

    height_el = args_dict["x1"]["height"]
    width_el = args_dict["x1"]["width"]
    pad_info = get_interlayer_padding(H_HR=height_el, W_HR=width_el,
                                      ratio=scale_factor)
    p_size_el = pad_info["P_HR"]
    p_size_bl = pad_info["P_LR"]
    hb_pad, wb_pad = pad_info["LR_padded_size"]
    he_pad, we_pad = pad_info["HR_padded_size"]
    hb, wb = pad_info["LR_size"]
    he, we = pad_info["HR_size"]
    # the reference derives one window size from the BL height and applies
    # it to both layers' RGB MS-SSIM (`test.py:255-259`)
    win_size = 7 if hb <= 160 else 11
    if write_stream:
        bin_dirs = {layer: os.path.join(args_dict["bin_folder"], ratio, layer)
                    for layer in ("BL", "EL")}
        for folder in bin_dirs.values():
            os.makedirs(folder, exist_ok=True)

    reader = YUVReader(args_dict["yuv_path_el"], we, he)
    frames_bl, frames_el, frame_types = [], [], []
    enc_bl = dec_bl = enc_el = dec_el = 0.0
    dpb = None
    pending = None  # the previous frame, whose metrics are still to do
    start_time = time.time()

    def process_metrics(frame_idx, copy, rgb_bl, rgb_el, planes_bl,
                        planes_el):
        out = copy.get()
        frames_bl.append(_layer_metrics(float(out["bit_bl"]), rgb_bl,
                                        *planes_bl, out["x_hat_bl"], win_size))
        frames_el.append(_layer_metrics(float(out["bit_el"]), rgb_el,
                                        *planes_el, out["x_hat_el"], win_size))
        if verbose and "warp_frame" in out:
            print("warp psnr:", _psnr_rgb(out["warp_frame"], rgb_el))
        save_artifacts(args_dict, ratio, frame_idx, out)

    for frame_idx in range(frame_num):
        y_el, uv_el = reader.read_one_frame()
        x_bl_padded, x_el_padded, rgb_el = layer_inputs(y_el, uv_el, pad_info,
                                                        device)
        # the frame's one sync point: the BL reference's YUV planes
        rgb_bl = pad_nhwc(x_bl_padded, inverse_padding_size(p_size_bl)) \
            .cpu().numpy()[0].transpose(2, 0, 1)
        y_bl, uv_bl = rgb_to_ycbcr420(rgb_bl)

        i_frame_net.set_scale_information(scale_factor, (he_pad, we_pad),
                                          (0, 0, 0, 0))
        if video_net is not None:
            video_net.set_scale_information(scale_factor, (he_pad, we_pad),
                                            (0, 0, 0, 0))

        if write_stream:
            bin_bl, bin_el = (os.path.join(bin_dirs[layer], f"{frame_idx}.bin")
                              for layer in ("BL", "EL"))
        if frame_idx % gop_size == 0:
            rdo = {"rdo": bool(args_dict.get("intra_rdo")),
                   "rdo_opt": args_dict.get("intra_rdo_opt")}
            if write_stream:
                result = i_frame_net.encode_decode(
                    x_bl_padded, x_el_padded, bin_bl, bin_el,
                    hb_pad, wb_pad, he_pad, we_pad, **rdo)
            else:
                result = i_frame_net.forward(x_bl_padded, x_el_padded, **rdo)
            dpb = {
                "ref_frame_bl": result["x_hat_bl"],
                "ref_frame_el": result["x_hat_el"],
                "ref_feature_bl": None,
                "ref_feature_el": result["feature_el"],
            }
            frame_types.append(0)
        else:
            if write_stream:
                result = video_net.encode_decode(
                    x_bl_padded, x_el_padded, dpb, bin_bl, bin_el,
                    we_pad, he_pad, wb_pad, hb_pad)
                enc_bl += result["encoding_time_BL"]
                dec_bl += result["decoding_time_BL"]
                enc_el += result["encoding_time_EL"]
                dec_el += result["decoding_time_EL"]
            else:
                result = video_net.forward_one_frame(
                    x_bl_padded, x_el_padded, dpb["ref_frame_bl"],
                    dpb["ref_frame_el"], dpb["ref_feature_bl"],
                    dpb["ref_feature_el"])
            dpb = result["dpb"]
            frame_types.append(1)

        # the reference clamps the DPB frames in place (`test.py:249-250`),
        # so later frames reference the clamped frames
        ref_bl = dpb["ref_frame_bl"].clamp_(0, 1)
        ref_el = dpb["ref_frame_el"].clamp_(0, 1)
        outputs = {
            # a stream's bits are ints (file sizes), estimated ones tensors
            "bit_bl": torch.as_tensor(result["bit_bl"]),
            "bit_el": torch.as_tensor(result["bit_el"]),
            "x_hat_bl": pad_nhwc(ref_bl, inverse_padding_size(p_size_bl)),
            "x_hat_el": pad_nhwc(ref_el, inverse_padding_size(p_size_el))}
        p_frame = "warp_frame" in result
        if p_frame and (verbose or args_dict.get("save_warp_frame")):
            outputs["warp_frame"] = pad_nhwc(
                torch.clamp(result["warp_frame"], 0, 1),
                inverse_padding_size(p_size_el))
        if p_frame and args_dict.get("save_decoded_mv"):
            outputs["mv"] = result["mv_hat"][0]
        if p_frame and args_dict.get("save_decoded_context"):
            # the channel mean in f32 on the device (the JAX package takes
            # it on the host): a (H, W) plane crosses, not 48 channels
            outputs["context"] = result["context"][0].float().mean(dim=-1)
        this = (frame_idx, HostCopy(outputs), rgb_bl, rgb_el,
                (y_bl[0], uv_bl[0], uv_bl[1]), (y_el[0], uv_el[0], uv_el[1]))
        if pending is not None:
            process_metrics(*pending)
        pending = this

    if pending is not None:
        process_metrics(*pending)
    reader.close()
    test_time = time.time() - start_time

    pixel_bl, pixel_el = hb * wb, he * we
    log_bl = aggregate_layer_log(frames_bl, frame_types, pixel_bl, test_time,
                                 enc_bl, dec_bl)
    log_el = aggregate_layer_log(frames_el, frame_types, pixel_el, test_time,
                                 enc_el, dec_el)
    bits_fl = [b.bit + e.bit for b, e in zip(frames_bl, frames_el)]
    log_fl = aggregate_layer_log(frames_el, frame_types, pixel_el, test_time,
                                 enc_bl + enc_el, dec_bl + dec_el,
                                 include_yuv_list=False,
                                 bits_override=bits_fl)
    return log_bl, log_el, log_fl
