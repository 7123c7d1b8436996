"""Two-layer stream decoder CLI of the port (the twin of the root
`decode.py`).

    python -m lssvc_tpu_torch.decode --bin_dir bins/seq1/0/x2 \\
        --i_frame_model_path intra.pth --model_path video.pth \\
        --height 1080 --width 1920 --ratio x2 --gop 32 --frame_num 96 \\
        --yuv_out dec_el.yuv [--yuv_out_bl dec_bl.yuv] [--device cpu]

Decodes the per-frame bins `<bin_dir>/{BL,EL}/<t>.bin` that
`python -m lssvc_tpu_torch.test --write_stream 1` writes back to 8-bit
4:2:0 YUV, without the encoder: host rANS and the models' decoder stages,
a P-frame's two layers through the two-layer decoder
(`lssvc_stream.decode_frame_overlapped`: one layer's planes rANS-decode
on a worker thread while the card runs the other's stages), the DPB on
the device, the reference frames clamped to [0, 1] between frames as the
encoder's GOP loop clamps them.

A stream decodes only with what it was encoded with: the same kind of
device (a stream coded on the card decodes on the card, a CPU stream on
the CPU), the same `--precision` (a bf16 stream decodes only in bf16; an
int8 stream only in int8 with the encoder's `--int8_calib` table), and the
same OffsetDiversity cap (`LSSVC_OD_OFFSET_CAP`).
The decoder derives every scale-index plane as the encoder did, and the
last bits of the convolutions differ between devices (and between the
port and the JAX package), so a mismatch flips a scale bucket and
desynchronises the stream.  Nothing converts or retries.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .harness.runner import RATIO_FACTORS
from .models.intra_ss_stream import decompress_stream
from .models.lssvc_stream import decode_frame_overlapped
from .ops import pad_nhwc
from .ops.nn import od_offset_cap_from_env, precision_from_cli
from .parallel.scheduler import load_intra, load_video
from .utils.color import rgb_to_ycbcr420
from .utils.io import YUVWriter
from .utils.padding import get_interlayer_padding, inverse_padding_size
from .utils.platform import resolve_device
from .utils.stream import decode_p


def yuv_frame(picture: torch.Tensor, p_size) -> bytes:
    """A DPB picture (1, H, W, 3 in [0, 1], padded by `p_size`, on any
    device) -> its 8-bit 4:2:0 frame as YUVWriter writes it: cropped,
    converted to YCbCr 4:2:0, then rint(x * 255) clipped to [0, 255]
    (a bf16 picture as f32, exactly)."""
    rgb = pad_nhwc(picture, inverse_padding_size(p_size))[0] \
        .permute(2, 0, 1).float().cpu().numpy()
    y, uv = rgb_to_ycbcr420(rgb)
    planes = [np.clip(np.rint(p * 255), 0, 255).astype(np.uint8)
              for p in (y, uv)]
    return planes[0].tobytes() + planes[1].tobytes()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Decode on the kind of device, in the precision and with the "
               "OffsetDiversity cap (LSSVC_OD_OFFSET_CAP, px; 10 unless set, "
               "0 or empty for none) the stream was encoded with: any other "
               "desynchronises the stream.  It is the user's error, and "
               "nothing here detects or repairs it.")
    p.add_argument("--bin_dir", required=True,
                   help="directory holding the BL/ and EL/ per-frame bins")
    p.add_argument("--i_frame_model_path", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--height", type=int, required=True,
                   help="the EL's height before padding")
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--ratio", default="x2",
                   choices=["x1_5", "x2", "x3", "x4"])
    p.add_argument("--gop", type=int, default=32)
    p.add_argument("--frame_num", type=int, required=True)
    p.add_argument("--yuv_out", required=True, help="EL output YUV path")
    p.add_argument("--yuv_out_bl", default=None, help="BL output YUV path")
    p.add_argument("--precision", default="fp32",
                   choices=["fp32", "high", "bf16", "int8"],
                   help="MUST be the precision the stream was encoded "
                        "with: the decoder derives every scale-index plane "
                        "as the encoder did, and another precision flips "
                        "index buckets and desynchronises the stream (a "
                        "bf16 stream decodes only in bf16)")
    p.add_argument("--int8_calib", default=None,
                   help="for --precision int8: the SAME calibration table "
                        "the encoder used")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda): the kind of device "
                        "the stream was encoded on")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    precision, int8_table = precision_from_cli(args.precision,
                                               args.int8_calib)
    device = resolve_device(args.device)
    pad_info = get_interlayer_padding(H_HR=args.height, W_HR=args.width,
                                      ratio=RATIO_FACTORS[args.ratio])
    p_size_el, p_size_bl = pad_info["P_HR"], pad_info["P_LR"]
    hb_pad, wb_pad = pad_info["LR_padded_size"]
    he_pad, we_pad = pad_info["HR_padded_size"]
    hb, wb = pad_info["LR_size"]
    he, we = pad_info["HR_size"]

    i_net = load_intra(args.i_frame_model_path, device, precision,
                       int8_table)
    v_net = load_video(args.model_path, device, od_offset_cap_from_env(),
                       precision, int8_table)
    for net in (i_net, v_net):
        net.set_scale_information(RATIO_FACTORS[args.ratio], (he_pad, we_pad),
                                  (0, 0, 0, 0))
        net.update(force=True)

    writer_el = YUVWriter(args.yuv_out, we, he)
    writer_bl = YUVWriter(args.yuv_out_bl, wb, hb) if args.yuv_out_bl \
        else None
    dpb = None
    # the two-layer decoder's worker (host rANS beside the card's stages)
    pool = ThreadPoolExecutor(max_workers=1)
    t0 = time.perf_counter()
    try:
        for t in range(args.frame_num):
            bin_bl = os.path.join(args.bin_dir, "BL", f"{t}.bin")
            bin_el = os.path.join(args.bin_dir, "EL", f"{t}.bin")
            if t % args.gop == 0:
                res = decompress_stream(i_net, bin_bl, bin_el)
                dpb = {"ref_frame_bl": res["x_hat_bl"],
                       "ref_frame_el": res["x_hat_el"],
                       "ref_feature_bl": None,
                       "ref_feature_el": res["feature_el"]}
            else:
                dpb = decode_frame_overlapped(
                    v_net, decode_p(bin_bl), decode_p(bin_el), hb_pad,
                    wb_pad, he_pad, we_pad, dpb, pool)["dpb"]
            # the encoder's GOP loop clamps the reference frames in place
            dpb["ref_frame_bl"].clamp_(0, 1)
            dpb["ref_frame_el"].clamp_(0, 1)
            writer_el.write_one_frame(yuv_frame(dpb["ref_frame_el"],
                                                p_size_el))
            if writer_bl is not None:
                writer_bl.write_one_frame(yuv_frame(dpb["ref_frame_bl"],
                                                    p_size_bl))
    finally:
        pool.shutdown()
        writer_el.close()
        if writer_bl is not None:
            writer_bl.close()
    seconds = time.perf_counter() - t0
    print(f"decoded {args.frame_num} frames in {seconds:.2f} s "
          f"({args.frame_num / seconds:.3f} fps) -> {args.yuv_out}")


if __name__ == "__main__":
    main()
