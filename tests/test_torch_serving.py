"""The encode-only GOP loop of the port
(`lssvc_tpu_torch/harness/serving.py` `encode_gop`) against its evaluation
harness.

A synthetic 128x128 8-bit 4:2:0 sequence of 4 frames at gop 2 (I P I P),
x2, fp32, the OffsetDiversity cap at the serving 10 px, on the CPU, from
`.pth` checkpoints of the JAX package's `init_intra_ss(192)` and
`init_lssvc(0)` bridged by `params_from_jax`.  `encode_gop` writes the
bins of `run_test` with `write_stream` (the CLI in process) byte for byte;
`python -m lssvc_tpu_torch.decode --device cpu` in a fresh process
rebuilds the run's pictures from them byte for byte.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.harness import runner as trunner
from lssvc_tpu_torch.harness import serving
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.tools.synthetic import write_dataset

from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]
SIZE, FRAMES, GOP = 128, 4, 2


def _checkpoints(folder):
    intra, video = folder / "intra.pth", folder / "video.pth"
    for path, params, kind in ((intra, j_init_intra_ss(192), "intra_ss"),
                               (video, j_init_lssvc(0), "lssvc")):
        torch.save(params_from_jax({k: np.asarray(v)
                                    for k, v in params.items()}, kind), path)
    return intra, video


def test_encode_gop_writes_the_harness_bins(tmp_path, monkeypatch):
    monkeypatch.delenv("LSSVC_OD_OFFSET_CAP", raising=False)
    cfg = write_dataset(tmp_path / "ds", SIZE, SIZE, frames=FRAMES, gop=GOP,
                        seed=3)
    intra, video = _checkpoints(tmp_path)
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = trunner.HostCopy

    def recording(tensors):  # the run's (cropped, clamped) DPB pictures
        for k in pictures:
            pictures[k].append(tensors[k].clone())
        return real_copy(tensors)

    monkeypatch.setattr(trunner, "HostCopy", recording)
    bins = tmp_path / "bins"
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", str(intra),
              "--model_path", str(video), "--output_path",
              str(tmp_path / "out"), "--ratios", "x2", "--device", "cpu",
              "--write_stream", "1", "--stream_path", str(bins)])
    harness_dir = bins / "seq1" / "0" / "x2"

    i_net = scheduler.load_intra(str(intra), "cpu")
    v_net = scheduler.load_video(str(video), "cpu", OD_OFFSET_CAP_SERVING)
    frames, hw_bl, hw_el = serving.read_frames(
        tmp_path / "ds" / "seq1" / "x1.yuv", SIZE, SIZE, "x2", FRAMES, "cpu")
    for net in (i_net, v_net):
        net.update(force=True)
        net.set_scale_information(2.0, hw_el, (0, 0, 0, 0))
    gop_dir = tmp_path / "gop"
    paths = {layer: [gop_dir / layer / f"{t}.bin" for t in range(FRAMES)]
             for layer in ("BL", "EL")}
    for layer in paths:
        (gop_dir / layer).mkdir(parents=True)
    dpb, bits = serving.encode_gop(
        i_net, v_net, [f[0] for f in frames], [f[1] for f in frames], GOP,
        paths["BL"], paths["EL"], hw_bl, hw_el)

    for layer, layer_paths in paths.items():
        for t, path in enumerate(layer_paths):
            assert path.read_bytes() == \
                (harness_dir / layer / f"{t}.bin").read_bytes(), (layer, t)
    assert bits == [(8 * b.stat().st_size, 8 * e.stat().st_size)
                    for b, e in zip(paths["BL"], paths["EL"])]
    # the final DPB pictures are the run's last ones
    assert torch.equal(dpb["ref_frame_el"], pictures["x_hat_el"][-1])
    assert torch.equal(dpb["ref_frame_bl"], pictures["x_hat_bl"][-1])

    dec = subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(gop_dir), "--i_frame_model_path", str(intra), "--model_path",
         str(video), "--height", str(SIZE), "--width", str(SIZE),
         "--ratio", "x2", "--gop", str(GOP), "--frame_num", str(FRAMES),
         "--yuv_out", str(tmp_path / "el.yuv"), "--yuv_out_bl",
         str(tmp_path / "bl.yuv"), "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert dec.returncode == 0, dec.stderr
    for layer in ("el", "bl"):
        want = b"".join(yuv_frame(x, (0, 0, 0, 0))
                        for x in pictures[f"x_hat_{layer}"])
        assert (tmp_path / f"{layer}.yuv").read_bytes() == want, layer
