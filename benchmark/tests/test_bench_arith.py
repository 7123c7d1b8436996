"""The yardstick's arithmetic against counts made by hand at small
shapes: the warps' bytes, the FLOP count by dtype, the traced GOP's busy
time and gaps."""

import json

import pytest
import torch
import torch.nn.functional as F

from benchmark.lib import flops, launches, peaks, readers
from benchmark.lib.trace import Trace


def test_warp_bytes_by_hand():
    # f32 flow_warp, 1x4x6x3: read 72 floats, write 72, flows 48 floats
    assert launches.warp_bytes(("flow_warp", (1, 4, 6, 3), 0)) == \
        (72 + 72 + 48) * 4
    # bf16 pair 2+5 channels at 2x2: sources and outputs 28 values each
    # at 2 bytes, flow 8 floats
    assert launches.warp_bytes(("flow_warp_pair", (1, 2, 2, 2, 5), 1)) == \
        2 * 28 * 2 + 8 * 4
    # grouped: 1x1x1, 32 source channels in 16 groups, 48 units ->
    # 96 out channels (bf16); flow_x, flow_y, mask 48 floats each
    assert launches.warp_bytes(("grouped_warp", (1, 1, 1, 32, 48, 16), 1)) \
        == (32 + 96) * 2 + 3 * 48 * 4


def test_flops_by_dtype_by_hand():
    x = torch.randn(1, 8, 10, 12)
    w = torch.randn(16, 8, 3, 3)
    counter = flops.DtypeFlops()
    with counter:
        F.conv2d(x, w, padding=1)
        torch.mm(torch.randn(5, 7, dtype=torch.bfloat16),
                 torch.randn(7, 3, dtype=torch.bfloat16))
    assert counter.counts["float32"] == 2 * 16 * 8 * 9 * 10 * 12
    assert counter.counts["bfloat16"] == 2 * 5 * 7 * 3
    t = flops.seconds_at_peak(counter.counts)
    assert t == pytest.approx(2 * 16 * 8 * 9 * 120 / 67e12 + 210 / 989e12)


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(path)


def test_trace_reduction_by_hand(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.pframe",
         "ts": 0, "dur": 60, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.pframe",
         "ts": 60, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 61, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "void flow_warp_kernel<float>",
         "ts": 10, "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 25, "dur": 15,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 70, "dur": 10,
         "args": {"correlation": 3}},
    ]
    tr = _trace(tmp_path, ev)
    assert tr.window_s == pytest.approx(100e-6)
    # union: [10, 40] and [70, 80]
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.op_seconds(("flow_warp_kernel",)) == pytest.approx(20e-6)
    assert tr.seconds_by_span("bench.pframe") == pytest.approx(
        [35e-6, 10e-6])
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.pframe", pytest.approx(30e-6)]
    assert sorted(g[1] for g in gaps) == pytest.approx(
        [10e-6, 20e-6, 30e-6])
    run = {"trace": tr, "warp_calls": [("flow_warp", (1, 4, 6, 3), 0)],
           "warp_kernels": ("flow_warp_kernel",)}
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert readers.warp_roofline(run) == pytest.approx(
        100 * 768 / peaks.HBM_BYTES_PER_S / 20e-6)
    assert readers.pframe_device_ms(run) == pytest.approx(22.5e-3)


def test_readers_return_nothing_without_readings(tmp_path):
    tr = _trace(tmp_path, [{"ph": "X", "cat": "user_annotation",
                            "name": "bench.stretch", "ts": 0, "dur": 10}])
    run = {"trace": tr, "warp_calls": [],
           "warp_kernels": ("flow_warp_kernel",), "ops": {},
           "types": {"I": 0, "P": 0}, "elapsed": 1.0, "rans_s": 0.0}
    assert readers.warp_roofline(run) is None
    assert readers.mfu(run) is None
    assert readers.pframe_device_ms(run) is None
    assert readers.rans_ms(run) is None


def test_mfu_holds_each_frame_type_to_its_peak():
    run = {"ops": {"I": {"bfloat16": 989e12},
                   "P": {"bfloat16": 989e12 * 0.5, "float32": 67e12 * 0.25}},
           "types": {"I": 1, "P": 4}, "elapsed": 10.0}
    # 1 s + 4 x 0.75 s at peak over 10 s
    assert readers.mfu(run) == pytest.approx(40.0)
