"""The launch recorder for the program's warp kernels, and each launch's
bytes.

`LaunchRecorder` is a copy of `chip_smoke.py` `LaunchRecorder` (commit
4d8626f; the packed pair entry point added).  It stands in for the
kernels' library: it records each launch's shape and calls the library
on.  `recording(warp_module)` swaps it in for a block, by the module's
`_lib` function, which every launch calls.
"""

from __future__ import annotations

import contextlib

# element sizes of the kernels' dtype codes
WARP_ELT = {0: 4, 1: 2}              # warp.cu: f32, bf16
FLOW_ELT = 4                         # flows and masks are f32


class LaunchRecorder:
    """Stands in for warp.cu's library: flow_warp (n, h, w, c); the pair
    entry points (n, h, w, ca, cb); grouped_warp (n, h, w, c_src, go,
    group_num); each with its dtype code."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def lssvc_flow_warp(self, *args):
        self.calls.append(("flow_warp", tuple(args[3:7]), args[7]))
        return self.lib.lssvc_flow_warp(*args)

    def lssvc_flow_warp_pair(self, *args):
        self.calls.append(("flow_warp_pair", tuple(args[5:10]), args[10]))
        return self.lib.lssvc_flow_warp_pair(*args)

    def lssvc_flow_warp_pair_packed(self, *args):
        self.calls.append(("flow_warp_pair", tuple(args[4:9]), args[9]))
        return self.lib.lssvc_flow_warp_pair_packed(*args)

    def lssvc_grouped_warp(self, *args):
        self.calls.append(("grouped_warp", tuple(args[5:11]), args[11]))
        return self.lib.lssvc_grouped_warp(*args)


@contextlib.contextmanager
def recording(warp_module):
    """Within the block every warp launch is recorded: yields the
    recorder."""
    real = warp_module._lib
    rec = LaunchRecorder(real())
    warp_module._lib = lambda: rec
    try:
        yield rec
    finally:
        warp_module._lib = real


def warp_bytes(call) -> int:
    """The byte bound of one warp launch: each input read once (the
    sources in their dtype, f32 flows and masks), each output written
    once."""
    kind, dims, dtype = call
    elt = WARP_ELT[dtype]
    if kind == "flow_warp":
        n, h, w, c = dims
        return n * h * w * (2 * c * elt + 2 * FLOW_ELT)
    if kind == "flow_warp_pair":
        n, h, w, ca, cb = dims
        return n * h * w * (2 * (ca + cb) * elt + 2 * FLOW_ELT)
    if kind == "grouped_warp":
        n, h, w, c_src, go, groups = dims
        c_out = go * (c_src // groups)
        return n * h * w * ((c_src + c_out) * elt + 3 * go * FLOW_ELT)
    raise ValueError(f"warp launch {kind!r}")
