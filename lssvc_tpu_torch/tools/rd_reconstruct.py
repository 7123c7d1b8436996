"""Rebuild an rd_experiment report JSON from its run log (the twin of the
JAX package's `tools/rd_reconstruct.py`).

    python -m lssvc_tpu_torch.tools.rd_reconstruct runs/rd_log.txt \
        --out runs/rd/rd_report.json [--modes fp32 bf16] \
        [--lambdas 0.003 0.01 0.03 0.09] [--force] [--device cuda]

`python -m lssvc_tpu_torch.tools.rd_experiment` prints every finished rate
point as

    <mode> lmbda=<l>: bpp=<b> rgb-psnr=<p>

before it writes its report, so a run killed mid-evaluation still has its
points in the log.  This tool parses those lines (the last one of each
(mode, lambda) wins: a relaunch may evaluate a point again) and writes the
report schema rd_experiment writes, with the BD-rate delta where both
modes have at least 4 points (`harness/bd_rate.py`).  It refuses to
overwrite a report unless `--force` is given.  It reads and writes files
only; `--device` is accepted as every tool of the port accepts it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from ..harness.bd_rate import bd_rate

LINE = re.compile(
    r"^\s*(?P<mode>\w+) lmbda=(?P<lm>[0-9.e-]+): "
    r"bpp=(?P<bpp>[0-9.]+) rgb-psnr=(?P<psnr>[0-9.]+)\s*$")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log")
    ap.add_argument("--out", required=True)
    ap.add_argument("--modes", nargs="+", default=["fp32", "bf16"])
    ap.add_argument("--lambdas", type=float, nargs="+",
                    default=[0.003, 0.01, 0.03, 0.09])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="accepted for the port's tools' common flag; no "
                         "device work is done")
    return ap.parse_args(argv)


def read_points(path, modes) -> dict:
    """(mode, lambda) -> (bpp, psnr) of the log's point lines, the last
    occurrence of each winning."""
    found = {}
    with open(path) as f:
        for line in f:
            m = LINE.match(line)
            if m and m.group("mode") in modes:
                found[(m.group("mode"), float(m.group("lm")))] = (
                    float(m.group("bpp")), float(m.group("psnr")))
    return found


def main(argv=None):
    args = parse_args(argv)
    if os.path.exists(args.out) and not args.force:
        sys.exit(f"{args.out} already exists (the run finished?); "
                 f"pass --force to overwrite")

    found = read_points(args.log, args.modes)
    curves = {}
    for mode in args.modes:
        pts = [found[(mode, lm)] for lm in args.lambdas
               if (mode, lm) in found]
        missing = [lm for lm in args.lambdas if (mode, lm) not in found]
        if missing:
            print(f"note: mode {mode} missing lambdas {missing} "
                  f"(killed before they evaluated)", file=sys.stderr)
        if pts:
            curves[mode] = pts
    if not curves:
        sys.exit("no RD points found in the log; nothing to reconstruct")

    report = {"lambdas": args.lambdas, "curves": curves,
              "reconstructed_from": args.log}
    # the curves first: the BD fit below may raise on degenerate or partial
    # curves, which must not lose them
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    ab = args.modes[:2]
    if all(m in curves and len(curves[m]) >= 4 for m in ab):
        a, b = (curves[m] for m in ab)
        try:
            report["bd_rate_delta_pct"] = bd_rate(
                [p[0] for p in a], [p[1] for p in a],
                [p[0] for p in b], [p[1] for p in b])
        except ValueError as e:
            print(f"BD-rate fit failed ({e}); curves-only report kept",
                  file=sys.stderr)
        else:
            print(f"BD-rate {ab[1]} vs {ab[0]}: "
                  f"{report['bd_rate_delta_pct']:+.3f}%")
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
    print(f"report -> {args.out}")


if __name__ == "__main__":
    main()
