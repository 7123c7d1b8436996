"""The per-layer metrics read from the program's own spans
(`lssvc_tpu_torch/utils/spans.py`).  The program's recorder is on while
the profiler records, so after a traced run its ring holds the spans of
the traced GOP alone (1 I-frame, 31 P-frames); `snapshot()` reads it.

Each metric is a mean over the P-frames whose frame span is in the ring
(`lssvc.p.encode` in an encode cell, `lssvc.p.decode` in a decode cell);
"main thread" is the frame span's thread, which launches the card's work.
A span nested in another of the kinds a metric subtracts or sums is not
counted again.  Each returns None where the program has no recorder, or
its ring no P-frame, or the ring dropped records.

  * `issue_ms`: the frame span's wall time less its main-thread waits
    (`lssvc.wait.*`) and, decoding, its main-thread rANS decodes
    (`lssvc.entropy.*`): the host issuing work;
  * `offcpu_ms.encode`: the frame span's wall time less its thread-CPU
    time: the launching thread off the CPU (the GIL, the worker, the OS)
    over the whole frame, since the program reads the thread-CPU clock
    only at a frame span's ends;
  * `host_syncs`: main-thread waits for the card a P-frame
    (`lssvc.wait.pace`, `.d2h`, `.h2d`);
  * `device_wait_ms.decode`: main-thread wall time in the waits for the
    card (`lssvc.wait.d2h`, `.h2d`);
  * `entropy_wait_ms.decode`: main-thread wall time in rANS decodes and
    waits for the worker (`lssvc.entropy.decode`, `lssvc.wait.worker`);
  * `rans_span_ms`: wall time in the frame's `lssvc.entropy.encode` /
    `.decode` spans, on any thread.

In a decode P-frame `issue_ms + device_wait_ms + entropy_wait_ms` is the
frame span's wall time; in an encode P-frame `issue_ms` and the pace
wait are.
"""

from __future__ import annotations

from collections import defaultdict

ENCODE, DECODE = "lssvc.p.encode", "lssvc.p.decode"
CARD_WAITS = {ENCODE: ("lssvc.wait.pace", "lssvc.wait.d2h",
                       "lssvc.wait.h2d"),
              DECODE: ("lssvc.wait.d2h", "lssvc.wait.h2d")}
ENTROPY_WAITS = ("lssvc.entropy.decode", "lssvc.wait.worker")


def snapshot():
    """The program's recorder's snapshot, or None where it has none."""
    try:
        from lssvc_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def _wall(r):
    return (r["end_ns"] - r["start_ns"]) * 1e-6


def _cpu(r):
    return (r["cpu_end_ns"] - r["cpu_start_ns"]) * 1e-6


def _outermost(recs, match, by_id):
    """The records whose name `match` accepts and none of whose ancestors'
    it does."""
    out = []
    for r in recs:
        if not match(r["name"]):
            continue
        p = by_id.get(r["parent"])
        while p is not None and not match(p["name"]):
            p = by_id.get(p["parent"])
        if p is None:
            out.append(r)
    return out


def _frame_numbers(frame, recs, by_id) -> dict:
    """The metrics' values of one P-frame: `frame` is its frame span,
    `recs` every record carrying its id."""
    main = [r for r in recs if r["thread"] == frame["thread"]
            and r is not frame]
    kind = frame["name"]
    card = CARD_WAITS[kind]
    if kind == ENCODE:
        blocking = _outermost(main, lambda n: n.startswith("lssvc.wait."),
                              by_id)
    else:
        blocking = _outermost(
            main, lambda n: n.startswith(("lssvc.wait.", "lssvc.entropy.")),
            by_id)
    issue = _wall(frame) - sum(_wall(r) for r in blocking)
    syncs = _outermost(main, lambda n: n in card, by_id)
    entropy = "lssvc.entropy.encode" if kind == ENCODE \
        else "lssvc.entropy.decode"
    return {
        "issue_ms": issue,
        "offcpu_ms": _wall(frame) - _cpu(frame),
        "host_syncs": float(len(syncs)),
        "device_wait_ms": sum(_wall(r) for r in blocking if r["name"] in card),
        "entropy_wait_ms": sum(_wall(r) for r in blocking
                               if r["name"] in ENTROPY_WAITS),
        "rans_span_ms": sum(_wall(r) for r in _outermost(
            recs, lambda n: n == entropy, by_id)),
        "frame_ms": _wall(frame),
    }


def per_frame(snap, kind) -> list[dict] | None:
    """Each P-frame's numbers (`_frame_numbers`) of frame span `kind`, in
    the order the frames ended; None where there are none to read."""
    if snap is None or snap.get("dropped"):
        return None
    recs = snap["spans"]
    by_id = {r["id"]: r for r in recs}
    frames = {r["frame"]: r for r in recs if r["name"] == kind}
    of = defaultdict(list)
    for r in recs:
        if r["frame"] in frames:
            of[r["frame"]].append(r)
    rows = [_frame_numbers(f, of[i], by_id) for i, f in frames.items()]
    return rows or None


def _metric(kind, key):
    def read(run, snap=None):
        rows = per_frame(snapshot() if snap is None else snap, kind)
        return None if rows is None else sum(r[key] for r in rows) / len(rows)
    read.__doc__ = f"The mean `{key}` of the `{kind}` P-frames."
    return read


issue_ms_encode = _metric(ENCODE, "issue_ms")
offcpu_ms_encode = _metric(ENCODE, "offcpu_ms")
host_syncs_encode = _metric(ENCODE, "host_syncs")
rans_span_ms_encode = _metric(ENCODE, "rans_span_ms")
issue_ms_decode = _metric(DECODE, "issue_ms")
host_syncs_decode = _metric(DECODE, "host_syncs")
device_wait_ms_decode = _metric(DECODE, "device_wait_ms")
entropy_wait_ms_decode = _metric(DECODE, "entropy_wait_ms")
rans_span_ms_decode = _metric(DECODE, "rans_span_ms")
