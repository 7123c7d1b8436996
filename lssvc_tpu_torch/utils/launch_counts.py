"""The kernel wrappers' launch counts of a process, written when it exits.

Each kernel wrapper counts its launches on itself (`<wrapper>.launches`).
A CLI that calls `dump_at_exit_from_env()` writes them, when its process
exits, to `$LSSVC_LAUNCH_COUNTS/launches-<pid>.json` ({"argv": ...,
"launches": {kernel: count}}) if that variable names a directory, so a run
can read the launches of the processes it started, and of theirs
(`chip_smoke.py` phase 20 reads those of `tools.rd_experiment` and of the
training stages it starts).  Nothing is written without the variable.
"""

from __future__ import annotations

import atexit
import json
import os
import sys

ENV = "LSSVC_LAUNCH_COUNTS"
# kernel -> (module, wrapper, counter); a module the process never
# imported launched nothing
COUNTERS = {
    "flow_warp": ("lssvc_tpu_torch.ops.warp_kernels", "flow_warp",
                  "launches"),
    "flow_warp_packed": ("lssvc_tpu_torch.ops.warp_kernels", "flow_warp",
                         "packed_launches"),
    "grouped_warp": ("lssvc_tpu_torch.ops.warp_kernels", "grouped_warp",
                     "launches"),
    "grouped_warp_packed": ("lssvc_tpu_torch.ops.warp_kernels",
                            "grouped_warp", "packed_launches"),
    "flow_warp_backward": ("lssvc_tpu_torch.ops.warp_kernels",
                           "flow_warp_backward", "launches"),
    "flow_warp_backward_fixed": ("lssvc_tpu_torch.ops.warp_kernels",
                                 "flow_warp_backward", "fixed_launches"),
    "grouped_warp_backward": ("lssvc_tpu_torch.ops.warp_kernels",
                              "grouped_warp_backward", "launches"),
    "grouped_warp_backward_fixed": ("lssvc_tpu_torch.ops.warp_kernels",
                                    "grouped_warp_backward",
                                    "fixed_launches"),
    "conv_chain": ("lssvc_tpu_torch.ops.conv_chain", "conv_chain",
                   "launches"),
    "int8_conv": ("lssvc_tpu_torch.ops.int8", "int8_conv2d", "launches"),
}


def counts() -> dict:
    """{kernel: launches so far in this process}."""
    out = {}
    for name, (module, wrapper, counter) in COUNTERS.items():
        mod = sys.modules.get(module)
        out[name] = int(getattr(getattr(mod, wrapper), counter)) \
            if mod is not None else 0
    return out


def _dump(folder):
    path = os.path.join(folder, f"launches-{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump({"argv": sys.argv, "launches": counts()}, f)


def dump_at_exit_from_env():
    """Write this process's counts at exit into $LSSVC_LAUNCH_COUNTS, if
    set."""
    folder = os.environ.get(ENV)
    if folder:
        atexit.register(_dump, folder)


def read_dumps(folder) -> list[dict]:
    """Every process's dump in `folder`."""
    out = []
    for name in sorted(os.listdir(folder)):
        if name.startswith("launches-") and name.endswith(".json"):
            with open(os.path.join(folder, name)) as f:
                out.append(json.load(f))
    return out
