"""Write an int8 activation-calibration table for the serving path (the
twin of the JAX package's `tools/int8_calibrate.py`).

    python -m lssvc_tpu_torch.tools.int8_calibrate --out calib.json
        [--ckpt video.pth] [--size 512] [--frames 3] [--margin 1.0]
        [--device cuda]

Runs the two-layer P-frame forward in the width-packed bf16 domain with the
model's absmax recorder open, over a few chained synthetic-motion frames
(`harness/calibrate.py`), and writes {calibration key: activation scale}
as JSON (indent 2, sorted keys), the JAX package's format: a table written
by either package loads in the other.  The table feeds `--precision int8
--int8_calib <json>` of `python -m lssvc_tpu_torch.test` and
`python -m lssvc_tpu_torch.decode`; `python -m lssvc_tpu_torch.bench --mode
int8_packed` calibrates itself.  Scales are per-tensor symmetric
(absmax * margin / 127); weights are quantized per output channel when a
model is built and need no table.  Runs on `cuda` unless `--device` says
otherwise.
"""

from __future__ import annotations

import argparse
import json

from ..bench import load_params
from ..harness.calibrate import calibrate_video


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="video model checkpoint (.pth or .npz); random "
                         "init if omitted")
    ap.add_argument("--size", type=int, default=512,
                    help="EL height = width of the calibration forward")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--margin", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    table = calibrate_video(load_params(args.ckpt), size=args.size,
                            frames=args.frames, margin=args.margin,
                            device=args.device)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
    print(f"{len(table)} scales -> {args.out}")
    return table


if __name__ == "__main__":
    main()
