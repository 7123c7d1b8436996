"""The arithmetic of the per-layer metrics, over what a traced run holds
(`run.py` `run_cell`'s `layer_run`): the traced GOP's `Trace`, the warp
launches recorded in it, each frame type's operations, the window's
frames and seconds, and the rANS coder's host seconds.  Each
returns None where the run holds nothing to read."""

from __future__ import annotations

from . import peaks
from .flops import seconds_at_peak
from .launches import warp_bytes


def idle_share(run):
    tr = run["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(run):
    """The window's frames' operations at each dtype's peak, over the
    window's seconds."""
    ops, types = run["ops"], run["types"]
    if not ops or run["elapsed"] <= 0:
        return None
    at_peak = sum(types[k] * seconds_at_peak(ops[k]) for k in ops)
    if set(ops) != {k for k, n in types.items() if n}:
        return None
    return 100.0 * at_peak / run["elapsed"]


def pframe_device_ms(run):
    per = run["trace"].seconds_by_span("bench.pframe")
    return 1e3 * sum(per) / len(per) if per else None


def warp_roofline(run):
    spent = run["trace"].op_seconds(run["warp_kernels"])
    if not run["warp_calls"] or spent <= 0:
        return None
    bound = sum(warp_bytes(c) for c in run["warp_calls"]) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / spent


def rans_ms(run):
    """Host ms a P-frame inside the rANS coder's calls (`FrameLog.rans_s`:
    the encoder's on the worker, or the decoder's), over the window."""
    n = run["types"].get("P", 0)
    if not n or run.get("rans_s") is None:
        return None
    return 1e3 * run["rans_s"] / n
