"""The int8 streams of the port through both CLIs, on the CPU: an encode with
`--precision int8 --int8_calib --write_stream 1`, then a decode in a fresh
process, byte for byte.  The table is the JAX package's calibration of the
P-frame of `tests/test_torch_int8.py`, whose fixtures this file shares; the
test lives apart so that it runs beside that file on another worker."""

import json
import subprocess
import sys
from pathlib import Path

from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.harness import runner as trunner
from lssvc_tpu_torch.tools.synthetic import write_dataset

from test_torch_int8 import (  # noqa: F401  (fixtures, found by name)
    _checkpoints, counting_sites, frame_inputs, jax_calibrated, table,
    video_params)

from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]


def test_int8_streams_round_trip_through_both_clis(tmp_path, monkeypatch,
                                                   table):
    """`--precision int8 --int8_calib t.json --write_stream 1` on a 3-frame
    GOP (I P P), then `python -m lssvc_tpu_torch.decode --precision int8
    --int8_calib t.json` in a fresh process rebuilds the run's EL and BL
    pictures byte for byte; the P-frames went through the int8 sites."""
    h, w, frames = 128, 128, 3
    cfg = write_dataset(tmp_path / "ds", h, w, frames=frames, gop=3, seed=5)
    intra, video = _checkpoints(tmp_path)
    calib = tmp_path / "t.json"
    calib.write_text(json.dumps(table, indent=2, sort_keys=True))
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = trunner.HostCopy

    def recording(tensors):
        for k in pictures:
            pictures[k].append(tensors[k].clone())
        return real_copy(tensors)

    monkeypatch.setattr(trunner, "HostCopy", recording)
    bins = tmp_path / "bins"
    with counting_sites() as calls:
        cli.main(["--test_config", str(cfg), "--i_frame_model_path",
                  str(intra), "--model_path", str(video), "--output_path",
                  str(tmp_path / "out"), "--ratios", "x2", "--device", "cpu",
                  "--precision", "int8", "--int8_calib", str(calib),
                  "--write_stream", "1", "--stream_path", str(bins)])
    assert calls[0] > 0
    dec = subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bins / "seq1" / "0" / "x2"), "--i_frame_model_path",
         str(intra), "--model_path", str(video), "--height", str(h),
         "--width", str(w), "--ratio", "x2", "--gop", "3", "--frame_num",
         str(frames), "--precision", "int8", "--int8_calib", str(calib),
         "--yuv_out", str(tmp_path / "el.yuv"), "--yuv_out_bl",
         str(tmp_path / "bl.yuv"), "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert dec.returncode == 0, dec.stderr
    for layer in ("el", "bl"):
        want = b"".join(yuv_frame(x, (0, 0, 0, 0))
                        for x in pictures[f"x_hat_{layer}"])
        assert (tmp_path / f"{layer}.yuv").read_bytes() == want, layer
