"""Readings of the comparison's numbers, for the program and for its
control, on several seeds in one process: what the limits in a
configuration's `limits` are set from.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 15] [--out readings.json]

Each seed is one run of the cell (set-up, a window of `--seconds`, ending
at a GOP's end, then the comparison), and the same sampled frames judged
again with the control in the program's place: the plain reference at the
precision below the configuration's (`reference/judge.py` `LOWER`).  One
JSON line a seed: {"seed", "program": numbers, "control": numbers}.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of the benchmark's folder
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import run as R  # noqa: E402
from benchmark.reference.judge import LOWER  # noqa: E402


def readings(workload, seeds, seconds, device, config_update=None,
             mix_update=None):
    """Yields {"seed", "program", "control"} for each seed."""
    bench = R.load_benchmark()
    for seed in seeds:
        ctx = R.find_cell(bench, workload)
        ctx["config"].update(config_update or {})
        ctx["mix"].update(mix_update or {})
        lower = LOWER[ctx["config"]["precision"]]
        ctx.update(seed=seed, t_start=time.perf_counter())
        with tempfile.TemporaryDirectory(prefix="lssvc_ctl_") as workdir:
            res = R.run_cell(ctx, device, seconds, False, workdir,
                             controls=(lower,))
        yield {"seed": seed, "lower": lower, "program": res["numbers"],
               "control": res["control"][lower],
               "frames": res["attempted"], "missing": res["failed"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for row in readings(args.workload, args.seeds, args.seconds,
                        torch.device("cuda:0")):
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
