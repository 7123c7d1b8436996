"""The bench twin's `--mode int8_packed` on the CPU: it calibrates itself,
prints the JAX bench's two stderr lines and serves every site.  It shares
`counting_sites` with `tests/test_torch_int8.py` and lives apart so that it
runs beside that file on another worker."""

import numpy as np

from lssvc_tpu_torch import bench
from lssvc_tpu_torch.harness import calibrate
from lssvc_tpu_torch.models import LSSVC

from test_torch_int8 import counting_sites

from torch_threads import share_cores

share_cores()


def test_bench_twin_int8_packed_on_the_cpu(monkeypatch, capsys):
    """`--mode int8_packed` calibrates (here at 128x128, not 512: the
    size is the only change), prints the JAX bench's two stderr lines and
    serves every site; one int8 convolution a served site call."""
    real = calibrate.calibrate_video

    def small(params, size, frames, **kw):
        assert (size, frames) == (512, 2)
        return real(params, size=128, frames=1, **kw)

    frames = [0]
    real_fwd = LSSVC.forward_one_frame

    def counted(self, *args):
        frames[0] += 1
        return real_fwd(self, *args)

    class Clock:
        @staticmethod
        def perf_counter():
            return 0.5 * frames[0]

    monkeypatch.setattr(bench, "calibrate_video", small)
    monkeypatch.setattr(LSSVC, "forward_one_frame", counted)
    monkeypatch.setattr(bench, "time", Clock)
    with counting_sites() as calls:
        line = bench.main(["--mode", "int8_packed", "--device", "cpu",
                           "--size", "128x128", "--frames", "1"])
    err = capsys.readouterr().err
    assert "# int8 calibration: 102 conv sites" in err
    assert "# int8 sites active in step: 102" in err
    assert line["mode"] == "int8_packed" and np.isfinite(line["bits"])
    assert line["int8_sites"] == line["int8_served"] == 102
    assert calls[0] == line["int8_served_calls"] > 0
