"""Reduction of a `torch.profiler` trace (its Chrome-trace export) to what
the per-layer metrics read: the device's operations inside the traced
stretch, their union (busy time), the idle gaps labelled by the
benchmark's span the host was in, and each device operation's launching
span.

The benchmark's spans are `record_function` ranges whose names start
with `bench.` (`SPAN_PREFIX`); the stretch is the one named `STRETCH`.
Times in the export are microseconds on one clock for host and device.
"""

from __future__ import annotations

import json
from collections import defaultdict

SPAN_PREFIX = "bench."
STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launch_ts = {}
        self.spans = []      # (start, end, name, tid) on the host
        self.ops = []        # (start, end, name, launch ts or None)
        raw_ops = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                raw_ops.append((ts, ts + dur, e.get("name", ""),
                                (e.get("args") or {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = ts
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(SPAN_PREFIX):
                self.spans.append((ts, ts + dur, e["name"], e.get("tid")))
        stretch = [s for s in self.spans if s[2] == STRETCH]
        if not stretch:
            raise ValueError("the trace holds no stretch span")
        self.t0, self.t1 = stretch[0][0], stretch[0][1]
        for a, b, name, corr in raw_ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                self.ops.append((a, b, name, launch_ts.get(corr)))
        self.ops.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def union(self) -> list[tuple[float, float]]:
        out = []
        for a, b, _, _ in self.ops:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union()) * 1e-6

    def op_seconds(self, match) -> float:
        """Summed seconds of the device operations whose name contains
        any of `match`."""
        return sum(b - a for a, b, name, _ in self.ops
                   if any(m in name for m in match)) * 1e-6

    def seconds_by_span(self, span_name) -> list[float]:
        """Per span named `span_name`: the summed seconds of the device
        operations launched inside it."""
        out = []
        for s0, s1, name, _ in self.spans:
            if name != span_name:
                continue
            out.append(sum(b - a for a, b, _, ts in self.ops
                           if ts is not None and s0 <= ts <= s1) * 1e-6)
        return out

    def top_ops(self, k=10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.ops:
            by[name] += (b - a) * 1e-6
        return sorted(([n[:200], s] for n, s in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k=10) -> list:
        """The `k` longest stretches with no device operation, each named
        by the innermost benchmark span (other than the stretch) that held
        the host at the gap's middle."""
        edges, at = [], self.t0
        for a, b in self.union():
            if a > at:
                edges.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            edges.append((at, self.t1))
        gaps = []
        for a, b in sorted(edges, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            holding = [s for s in self.spans if s[2] != STRETCH
                       and s[0] <= mid <= s[1]]
            label = (min(holding, key=lambda s: s[1] - s[0])[2] if holding
                     else "outside the frames")
            gaps.append([label, (b - a) * 1e-6])
        return gaps
