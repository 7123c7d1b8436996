"""Per-frame EL PSNR over a GOP chain: the quick steady-state check of a
trained checkpoint pair (the twin of the JAX package's
`tools/chain_probe.py`).

    python -m lssvc_tpu_torch.tools.chain_probe \
        --video runs/rd2/video_l0p01_ft_step600.npz \
        --intra runs/rd2/intra_l0p01_step2000.npz [--frames 6] \
        [--yuv runs/rd2/eval_ds/eval/x1.yuv] [--size 256] \
        [--precision bf16] [--device cuda]

A healthy codec loses quality gently along the P-frame chain.  A
steady-state path that training never reached (the chain truncated to two
frames, so no P-frame with a feature in its DPB was trained) shows a cliff
between P-frame 1 (no feature: the trained configuration) and P-frame 2.
The tool codes the sequence's first `--frames` frames with estimated bits:
an IntraSS I-frame (BL 192 channels, from the weights), then LSSVC P-frames
(`models/lssvc_stream.py` `LSSVCExtend`, no offset cap), the pictures fed
back clamped to [0, 1] as the GOP loop does.  `--precision` bf16 and int8
run at packed width 2 (int8 with no calibration table: every site the
bf16 path).  It prints each frame's EL RGB PSNR and exits with code 1 where
P2 falls below 0.6 x P1's dB.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import load_params
from ..models import IntraSS
from ..models.lssvc_stream import LSSVCExtend
from ..utils.color import ycbcr420_to_rgb
from ..utils.io import YUVReader
from ..utils.launch_counts import dump_at_exit_from_env
from ..utils.platform import resolve_device
from ..utils.resize import imresize

# P2 must keep this share of P1's dB (the collapse measured ~19 -> ~8 dB;
# healthy chains lose < 2 dB)
CLIFF = 0.6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--video", required=True)
    ap.add_argument("--intra", required=True)
    ap.add_argument("--yuv", default="runs/rd2/eval_ds/eval/x1.yuv")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a run without "
                         "a GPU)")
    return ap.parse_args(argv)


def models(video, intra, precision, device):
    """(IntraSS, LSSVCExtend) from `.npz` checkpoints in `precision`, the
    JAX tool's packed width (2 for bf16 and int8)."""
    mode = dict(precision=precision,
                packed_width=2 if precision in ("bf16", "int8") else 1)
    if precision == "int8":
        mode["int8_table"] = {}
    vnet = LSSVCExtend(load_params(video, "lssvc")[0], device=device,
                       od_offset_cap=None, **mode)
    inet = IntraSS(load_params(intra, "intra_ss")[0], device=device, **mode)
    return inet, vnet


def read_frames(yuv, size, frames):
    """The sequence's first `frames` frames as 3xHxW RGB in [0, 1]."""
    reader = YUVReader(yuv, size, size)
    out = []
    for _ in range(frames):
        y, uv = reader.read_one_frame()
        out.append(ycbcr420_to_rgb(y, uv))
    reader.close()
    return out


def probe(inet, vnet, frames, size, device) -> list[float]:
    """Each frame's EL RGB PSNR (dB) along the chain I P P ..."""
    for net in (inet, vnet):
        net.set_scale_information(2.0, (size, size), (0, 0, 0, 0))
    psnrs, dpb = [], None
    with torch.no_grad():
        for t, rgb in enumerate(frames):
            x = torch.from_numpy(rgb[None]).to(device)  # 1x3xHxW
            x_el = x.permute(0, 2, 3, 1).contiguous()
            x_bl = imresize(x, sizes=(size // 2, size // 2)) \
                .permute(0, 2, 3, 1).contiguous()
            if t == 0:
                out = inet.forward(x_bl, x_el)
                rec = out["x_hat_el"]
                dpb = {"ref_frame_bl": out.get("x_hat_bl", x_bl).clamp(0, 1),
                       "ref_frame_el": rec.clamp(0, 1),
                       "ref_feature_bl": None, "ref_feature_el": None}
            else:
                out = vnet.forward_one_frame(
                    x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
                    dpb["ref_feature_bl"], dpb["ref_feature_el"])
                dpb = dict(out["dpb"])
                rec = dpb["ref_frame_el"]
                for k in ("ref_frame_bl", "ref_frame_el"):
                    dpb[k] = dpb[k].clamp(0, 1)
            rec = np.clip(rec.float().cpu().numpy(), 0, 1)
            mse = float(np.mean((rec - x_el.cpu().numpy()) ** 2))
            psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
            print(f"frame {t}: EL rgb psnr {psnrs[-1]:.2f} dB", flush=True)
    return psnrs


def cliff(psnrs) -> bool:
    """The cliff rule: P2 below CLIFF x P1's dB (three frames at least)."""
    return len(psnrs) >= 3 and psnrs[2] < CLIFF * psnrs[1]


def main(argv=None):
    args = parse_args(argv)
    dump_at_exit_from_env()
    device = resolve_device(args.device)
    inet, vnet = models(args.video, args.intra, args.precision, device)
    psnrs = probe(inet, vnet, read_frames(args.yuv, args.size, args.frames),
                  args.size, device)
    if cliff(psnrs):
        print(f"STEADY-STATE CLIFF: P1 {psnrs[1]:.1f} dB -> "
              f"P2 {psnrs[2]:.1f} dB", flush=True)
        raise SystemExit(1)
    print("chain healthy", flush=True)


if __name__ == "__main__":
    main()
