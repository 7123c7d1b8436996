"""A reference-scale evaluation fixture: a 96-frame 1080p synthetic YUV
sequence and its dataset config for the port's CLI (the twin of the JAX
package's `tools/ref_scale_eval.py`).

    python -m lssvc_tpu_torch.tools.ref_scale_eval --out runs/ref_scale \
        [--frames 96] [--gop 32] [--device cuda]

The reference's published results are 96-frame 1080p sequences.  With no
real dataset at hand the sequence is synthetic, with what a codec has to
work for: a smooth texture panning across the frame (global motion for
the MV path), two moving occluders (edges and disocclusions) and a slow
global brightness drift (P-frame residuals that do not vanish over a
32-frame GOP).  `synth_1080p` draws it from numpy's seed 11, byte for byte
as the JAX package's tool does.  The tool writes `<out>/ds/seq1080/x1.yuv`
(unless it exists) and `<out>/config.json`, and prints the
`python -m lssvc_tpu_torch.test` command for four rate points, on
`--device`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.io import YUVWriter, yuv420_bytes


def synth_1080p(path, n_frames, h=1080, w=1920, seed=11):
    """Write the sequence to `path`; returns `path`."""
    rng = np.random.default_rng(seed)
    # a 16x-upsampled smooth texture, wide enough to pan across
    small = rng.random((h // 16 + 16, w // 16 + 16, 3)).astype(np.float32)
    base = np.repeat(np.repeat(small, 16, axis=0), 16, axis=1)
    sq1, sq2 = h // 8, h // 5
    c1 = rng.random(3).astype(np.float32)
    c2 = rng.random(3).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wtr = YUVWriter(path, w, h)
    for t in range(n_frames):
        ox = int(2.0 * t) % (base.shape[1] - w)
        oy = int(1.0 * t) % (base.shape[0] - h)
        f = base[oy:oy + h, ox:ox + w].copy()
        y1 = (h // 4 + 3 * t) % (h - sq1)
        x1 = (w // 5 + 5 * t) % (w - sq1)
        f[y1:y1 + sq1, x1:x1 + sq1] = c1
        y2 = (h // 2 + int(1.5 * t)) % (h - sq2)
        x2 = (w // 2 - 4 * t) % (w - sq2)
        f[y2:y2 + sq2, x2:x2 + sq2] = c2
        f = np.clip(f * (0.9 + 0.1 * np.cos(2 * np.pi * t / n_frames)),
                    0.0, 1.0)
        wtr.write_one_frame(yuv420_bytes(f.transpose(2, 0, 1)))
    wtr.close()
    return path


def config(out: str, frames: int, gop: int) -> dict:
    """The CLI's dataset config of the sequence under `out`."""
    return {"SYN1080": {
        "test": 1,
        "base_path": os.path.join(out, "ds"),
        "x1": {"width": 1920, "height": 1080},
        "x2": {"width": 960, "height": 540},
        "sequences": {"seq1080": {"frames": frames, "gop": gop}},
    }}


def command(out: str, cfg_path: str, device: str) -> str:
    """The port's CLI over the four rate points of an rd_experiment run
    under runs/rd2."""
    lambdas = ["0p003", "0p01", "0p03", "0p09"]
    intra = " ".join(f"runs/rd2/intra_l{t}_step2000.npz" for t in lambdas)
    video = " ".join(f"runs/rd2/video_l{t}_ft_step600.npz" for t in lambdas)
    return ("run:\n"
            f"python -m lssvc_tpu_torch.test --test_config {cfg_path} \\\n"
            f"  --i_frame_model_path {intra} \\\n"
            f"  --model_path {video} \\\n"
            f"  --write_stream 1 --precision bf16 --ratios x2 --worker 1 \\\n"
            f"  --stream_path {out}/bins --output_path {out}/out \\\n"
            f"  --device {device}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="runs/ref_scale")
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--gop", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="the device of the printed command (default cuda)")
    args = p.parse_args(argv)

    yuv = os.path.join(args.out, "ds", "seq1080", "x1.yuv")
    if not os.path.exists(yuv):
        synth_1080p(yuv, args.frames)
        print(f"wrote {yuv}")
    cfg_path = os.path.join(args.out, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config(args.out, args.frames, args.gop), f, indent=2)
    print(f"wrote {cfg_path}")
    print(command(args.out, cfg_path, args.device))


if __name__ == "__main__":
    main()
