"""RD comparison and BD-rate CLI of the port (the twin of the root
`compare_rd.py`, the reference's `compare_rd_video.py`): loads
`{ratio}_{BL,EL,FL}.json` result files of several methods, aggregates
frame-weighted class-level RD points, prints per-class and per-sequence
tables, computes BD-rate against an anchor and draws RD curves.

    python -m lssvc_tpu_torch.compare_rd \\
        --results LSSVC=path/x2_FL.json SHM=anchor/x2_FL.json \\
        --anchor SHM [--metric rgb_psnr] [--plot out.png] [--per-sequence]

numpy and the standard library only; `--plot` imports matplotlib when it
draws, and without matplotlib it says so and exits 2 after the tables.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys

import numpy as np

from .harness.bd_rate import bd_rate


def ssim_to_db(ssim):
    return -10 * np.log10(1 - ssim)


def load_results(path):
    with open(path) as f:
        return json.load(f)


def weighted_class_points(data, metric="rgb_psnr"):
    """dataset -> list of (bpp, quality) rate points (one per checkpoint),
    frame-count-weighted over sequences."""
    out = {}
    for ds_name, seqs in data.items():
        per_ckpt = {}
        for seq, ckpts in seqs.items():
            for ckpt, m in ckpts.items():
                per_ckpt.setdefault(ckpt, []).append(m)
        points = []
        for ckpt in sorted(per_ckpt):
            models = per_ckpt[ckpt]
            frames = np.array([m["i_frame_num"] + m["p_frame_num"]
                               for m in models], dtype=np.float64)
            bpp = np.array([m["ave_all_frame_bpp"] for m in models])
            q = np.array([_metric_value(m, metric) for m in models])
            w = frames / frames.sum()
            points.append((float((bpp * w).sum()), float((q * w).sum())))
        # rate points in bpp order: checkpoint keys sort lexicographically
        # ('10_m' < '2_m'), which would zigzag the plotted RD curve
        out[ds_name] = sorted(points)
    return out


def _metric_value(m, metric):
    """One quality value per result dict — SSIM metrics in dB (the
    convention every consumer here uses)."""
    if metric == "rgb_psnr":
        return m["ave_all_frame_rgb_psnr"]
    if metric == "psnr":
        return m["ave_all_frame_psnr"]
    if metric == "msssim":
        return float(ssim_to_db(np.array(m["ave_all_frame_msssim"])))
    if metric == "rgb_msssim":
        return float(ssim_to_db(np.array(m["ave_all_frame_rgb_msssim"])))
    raise ValueError(metric)


def sequence_points(data, metric="rgb_psnr"):
    out = {}
    for ds_name, seqs in data.items():
        for seq, ckpts in seqs.items():
            pts = [(ckpts[c]["ave_all_frame_bpp"],
                    _metric_value(ckpts[c], metric))
                   for c in sorted(ckpts)]
            out[(ds_name, seq)] = sorted(pts)
    return out


def plot_curves(methods, datasets, metric, path):
    """One RD panel per dataset, every method's class points, to `path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(datasets)
    ncols = min(n, 3)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows),
                             squeeze=False)
    for i, ds in enumerate(datasets):
        ax = axes[i // ncols][i % ncols]
        for label, classes in methods.items():
            if ds not in classes:
                continue
            b, q = zip(*classes[ds])
            ax.plot(b, q, marker="o", label=label)
        ax.set_title(ds)
        ax.set_xlabel("bpp")
        ax.set_ylabel(metric)
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main(argv=None):
    """Print the tables; returns 0, or 2 when `--plot` finds no
    matplotlib."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", nargs="+", required=True,
                        help="label=path pairs of result JSONs")
    parser.add_argument("--anchor", type=str, default=None,
                        help="label used as BD anchor (default: first)")
    parser.add_argument("--metric", type=str, default="rgb_psnr",
                        choices=["rgb_psnr", "psnr", "msssim", "rgb_msssim"])
    parser.add_argument("--plot", type=str, default=None,
                        help="output PNG path for RD curves")
    parser.add_argument("--per-sequence", action="store_true")
    args = parser.parse_args(argv)

    methods = {}
    for spec in args.results:
        label, path = spec.split("=", 1)
        methods[label] = weighted_class_points(load_results(path), args.metric)
    anchor = args.anchor or next(iter(methods))

    datasets = sorted(set().union(*[set(m) for m in methods.values()]))
    print(f"\n=== RD points ({args.metric}) ===")
    for ds in datasets:
        print(f"\n[{ds}]")
        for label, classes in methods.items():
            if ds not in classes:
                continue
            pts = "  ".join(f"({b:.4f}, {q:.2f})" for b, q in classes[ds])
            print(f"  {label:12s} {pts}")

    print(f"\n=== BD-rate vs {anchor} (%; negative = better) ===")
    for label, classes in methods.items():
        if label == anchor:
            continue
        row = {}
        for ds in datasets:
            if ds not in classes or ds not in methods[anchor]:
                continue
            ra, pa = zip(*methods[anchor][ds])
            rt, pt = zip(*classes[ds])
            try:
                row[ds] = bd_rate(ra, pa, rt, pt)
            except Exception as exc:
                row[ds] = float("nan")
                print(f"  warn: {label}/{ds}: {exc}")
        cells = "  ".join(f"{ds}: {v:+.1f}" for ds, v in row.items())
        mean = np.nanmean(list(row.values())) if row else float("nan")
        print(f"  {label:12s} {cells}  | mean {mean:+.1f}")

    status = 0
    if args.plot and importlib.util.find_spec("matplotlib") is None:
        print(f"--plot {args.plot}: matplotlib is not installed, so no "
              "curves were drawn; the tables are above", file=sys.stderr)
        status = 2
    elif args.plot:
        plot_curves(methods, datasets, args.metric, args.plot)
        print(f"\nsaved RD curves to {args.plot}")

    if args.per_sequence:
        print("\n=== per-sequence RD points ===")
        for spec in args.results:
            label, path = spec.split("=", 1)
            pts = sequence_points(load_results(path), args.metric)
            print(f"\n[{label}]")
            for (ds, seq), p in sorted(pts.items()):
                cells = "  ".join(f"({b:.4f}, {q:.2f})" for b, q in p)
                print(f"  {ds}/{seq}: {cells}")
    return status


if __name__ == "__main__":
    sys.exit(main())
