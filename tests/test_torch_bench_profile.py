"""The bench twin's `--profile DIR` on the CPU: one steady chain of
min(K, 3) frames under torch.profiler (its CPU activity only here) writes a
Chrome trace and prints the top operators; the readings go on after it."""

import json

import numpy as np

from lssvc_tpu_torch import bench
from lssvc_tpu_torch.models import LSSVC

from torch_threads import share_cores

share_cores()


def test_bench_twin_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    frames = [0]
    real_fwd = LSSVC.forward_one_frame

    def counted(self, *args):
        frames[0] += 1
        return real_fwd(self, *args)

    class Clock:  # half a second a frame, so the readings agree
        @staticmethod
        def perf_counter():
            return 0.5 * frames[0]

    monkeypatch.setattr(LSSVC, "forward_one_frame", counted)
    monkeypatch.setattr(bench, "time", Clock)
    out = tmp_path / "prof"
    line = bench.main(["--mode", "fp32", "--device", "cpu", "--size",
                       "128x128", "--frames", "1", "--profile", str(out)])
    err = capsys.readouterr().err
    trace = out / "fp32_trace.json"
    assert trace.is_file()
    assert json.loads(trace.read_text())["traceEvents"]
    prof = line["profile"]
    assert prof["trace"] == str(trace) and prof["frames"] == 1
    assert prof["clock"] == "CPU" and prof["ms_per_frame"] > 0
    assert prof["int8_conv_ms_per_frame"] == 0 and prof["top"]
    assert "# profile: 1 frames of fp32" in err
    assert line["s_per_frame"] == 0.5 and np.isfinite(line["bits"])
