"""Host-side helpers of the frame loops: device tensors on their way to the
host, the harness's DPB clamp, and time points on the device's timeline.
"""

from __future__ import annotations

import time

import torch

from . import spans


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


class HostCopy:
    """The tensors of `tree` (dicts and lists of tensors) on their way to
    the host.  Made on the main thread: each CUDA tensor's copy into a
    pinned buffer is enqueued at once, non-blocking, and one event is
    recorded after them; CPU tensors are kept.  `get()`, on any thread,
    waits for that event only (the span `lssvc.wait.d2h`) and returns the
    tree of host tensors.  (A pinned buffer read before its event holds
    stale bytes; a copy into pageable memory would block the main
    thread.)"""

    def __init__(self, tree):
        self.event = None
        self.tree = _map(tree, self._copy)
        if self.event is not None:
            self.event.record()

    def _copy(self, t):
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        return host

    def get(self):
        if self.event is not None:
            with spans.span("lssvc.wait.d2h"):
                self.event.synchronize()
        return self.tree


def clamp_dpb(dpb: dict) -> dict:
    """The harness's inter-frame clamp of the DPB pictures to [0, 1] (the
    reference's `test.py:249-250`, as `harness/runner.py` applies it), out
    of place."""
    return dict(dpb, ref_frame_bl=torch.clamp(dpb["ref_frame_bl"], 0.0, 1.0),
                ref_frame_el=torch.clamp(dpb["ref_frame_el"], 0.0, 1.0))


class Stamps:
    """Time points on `device`'s timeline: on the card CUDA events recorded
    on the current stream (no sync; `seconds` reads them once the work
    before the later one has finished), on the CPU the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.points = []

    def stamp(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.points.append(event)
        else:
            self.points.append(time.perf_counter())

    def seconds(self, i: int, j: int) -> float:
        a, b = self.points[i], self.points[j]
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a
