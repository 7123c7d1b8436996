"""The per-layer metrics read from the program's spans
(`benchmark/lib/program_spans.py`), on hand-built snapshots of the
program's recorder: the arithmetic of each metric, a nested span not
counted twice, and None where there is nothing to read."""

import sys

import pytest

from benchmark import run as R
from benchmark.lib import program_spans as ps

MAIN, WORKER = 1, 2
METRICS = ("issue_ms.encode", "offcpu_ms.encode", "host_syncs.encode",
           "rans_span_ms.encode", "issue_ms.decode", "host_syncs.decode",
           "device_wait_ms.decode", "entropy_wait_ms.decode",
           "rans_span_ms.decode")


class Snap:
    """A snapshot built span by span, times in ms."""

    def __init__(self):
        self.spans = []

    def add(self, name, start, end, parent=None, thread=MAIN, cpu=None):
        """A span; `cpu` (ms) for a frame span, whose thread-CPU time
        alone the program reads."""
        rid = len(self.spans) + 1
        frame = rid if parent is None else self.spans[parent - 1]["frame"]
        self.spans.append({
            "name": name, "id": rid, "parent": parent, "frame": frame,
            "thread": thread, "start_ns": int(start * 1e6),
            "end_ns": int(end * 1e6),
            "cpu_start_ns": None if cpu is None else 0,
            "cpu_end_ns": None if cpu is None else int(cpu * 1e6)})
        return rid

    def snapshot(self, dropped=0):
        return {"spans": list(self.spans), "dropped": dropped}


def _encode_frame(s, t0, pace_ms, rans_ms):
    """A P-frame encode of 100 ms wall, 65 ms on the CPU, `pace_ms` of it
    in the pace wait, and its rANS on the worker."""
    f = s.add("lssvc.p.encode", t0, t0 + 100, cpu=65)
    s.add("lssvc.p.encode.bl", t0, t0 + 40, f)
    s.add("lssvc.p.encode.el", t0 + 40, t0 + 70, f)
    s.add("lssvc.p.encode.d2h", t0 + 70, t0 + 72, f)
    s.add("lssvc.wait.pace", t0 + 100 - pace_ms, t0 + 100, f)
    w = s.add("lssvc.p.write", t0 + 100, t0 + 100 + sum(rans_ms) + 5, f,
              thread=WORKER)
    s.add("lssvc.wait.d2h", t0 + 100, t0 + 101, w, thread=WORKER)
    t = t0 + 101
    for ms in rans_ms:
        s.add("lssvc.entropy.encode", t, t + ms, w, thread=WORKER)
        t += ms


def _decode_frame(s, t0):
    """A P-frame decode of 200 ms: rANS on both threads, waits for the
    card (one nested in another, two inside a rANS decode), a wait for
    the worker."""
    f = s.add("lssvc.p.decode", t0, t0 + 200, cpu=150)
    st = s.add("lssvc.p.decode.bl.entropy_dec_mv_z", t0, t0 + 10, f)
    s.add("lssvc.entropy.decode", t0, t0 + 8, st)
    s.add("lssvc.wait.h2d", t0 + 8, t0 + 10, st)
    s.add("lssvc.entropy.decode", t0 + 10, t0 + 40, f, thread=WORKER)
    p = s.add("lssvc.p.decode.el.y_pass0", t0 + 50, t0 + 70, f)
    st = s.add("lssvc.p.decode.el.entropy_dec_y", t0 + 50, t0 + 62, p)
    d2h = s.add("lssvc.wait.d2h", t0 + 50, t0 + 55, st)
    s.add("lssvc.wait.h2d", t0 + 52, t0 + 54, d2h)  # nested: counted once
    s.add("lssvc.entropy.decode", t0 + 55, t0 + 60, st)
    s.add("lssvc.wait.h2d", t0 + 60, t0 + 62, st)
    s.add("lssvc.wait.worker", t0 + 100, t0 + 130, f)
    e = s.add("lssvc.entropy.decode", t0 + 150, t0 + 170, f)
    s.add("lssvc.wait.d2h", t0 + 150, t0 + 152, e)
    s.add("lssvc.wait.h2d", t0 + 168, t0 + 170, e)


def _read(name, snap):
    return R.load_reader(name)({}, snap)


def test_encode_arithmetic():
    s = Snap()
    s.add("lssvc.i.encode", 0, 50)
    _encode_frame(s, 100, pace_ms=28, rans_ms=(59, 60))
    _encode_frame(s, 200, pace_ms=18, rans_ms=(50, 51))
    snap = s.snapshot()
    # issue: 100 - 28 and 100 - 18; off the CPU: the frame's 100 - 65
    assert _read("issue_ms.encode", snap) == pytest.approx(77.0)
    assert _read("offcpu_ms.encode", snap) == pytest.approx(35.0)
    assert _read("host_syncs.encode", snap) == 1.0
    assert _read("rans_span_ms.encode", snap) == pytest.approx(110.0)
    # issue plus the pace wait is the frame
    for row in ps.per_frame(snap, ps.ENCODE):
        assert row["issue_ms"] + row["device_wait_ms"] == \
            pytest.approx(row["frame_ms"])
    # the encode cell's snapshot holds no decoded P-frame
    assert _read("issue_ms.decode", snap) is None


def test_decode_arithmetic():
    s = Snap()
    s.add("lssvc.i.decode", 0, 50)
    _decode_frame(s, 100)
    _decode_frame(s, 400)
    snap = s.snapshot()
    # outermost waits and rANS on the main thread: 8 + 2 + 5 + 5 + 2 + 30
    # + 20 = 72 ms, of which waits for the card 2 + 5 + 2 (the nested
    # h2d, and those inside the rANS decode, not again)
    assert _read("issue_ms.decode", snap) == pytest.approx(128.0)
    assert _read("device_wait_ms.decode", snap) == pytest.approx(9.0)
    assert _read("entropy_wait_ms.decode", snap) == pytest.approx(63.0)
    # syncs: h2d, d2h (its nested h2d not again), h2d, and the two inside
    # the rANS decode
    assert _read("host_syncs.decode", snap) == 5.0
    # 8 + 5 + 20 on the main thread, 30 on the worker
    assert _read("rans_span_ms.decode", snap) == pytest.approx(63.0)
    for row in ps.per_frame(snap, ps.DECODE):
        assert row["issue_ms"] + row["device_wait_ms"] + \
            row["entropy_wait_ms"] == pytest.approx(row["frame_ms"])
    assert _read("issue_ms.encode", snap) is None


@pytest.mark.parametrize("name", METRICS)
def test_none_where_nothing_to_read(name, monkeypatch):
    read = R.load_reader(name)
    assert read({}, {"spans": [], "dropped": 0}) is None
    s = Snap()
    _encode_frame(s, 0, pace_ms=20, rans_ms=(50,))
    _decode_frame(s, 300)
    assert read({}, s.snapshot()) is not None
    assert read({}, s.snapshot(dropped=3)) is None
    # a program without the recorder (the parent of the change that added
    # it): nothing to read, and no error
    import lssvc_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "lssvc_tpu_torch.utils.spans", None)
    assert ps.snapshot() is None
    assert read({}) is None
