"""The port's GOP loop and CLI against the JAX package's.

`run_test` on a synthetic 8-bit 4:2:0 sequence of 120x104 (padded to
128x128, so the reconstructions are cropped), 3 frames at GOP 3 (I P P:
the first P-frame has no BL reference feature), full widths, fp32, the
OffsetDiversity cap at the serving 10 px on both sides.  Weights are the
JAX package's `init_intra_ss(192)` / `init_lssvc(0)` bridged by
`params_from_jax`.  Per frame: bits within 3e-3 relative, PSNRs within 0.1
dB, MS-SSIM within 5e-3 or NaN on both sides; equal frame types and key
sets.  Then the CLI (`python -m lssvc_tpu_torch.test`) on the CPU from
`.pth` checkpoints of the port's own init, with estimated bits and with
real bitstreams decoded again by `python -m lssvc_tpu_torch.decode` in a
fresh process, and the flags it refuses.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from lssvc_tpu.harness import runner as jrunner
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.models.dmc import DMCExtend as JDMC
from lssvc_tpu.models.intra_ss import IntraSS as JIntraSS
from lssvc_tpu.models.lssvc import LSSVCExtend as JLSSVC
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.harness import runner as trunner
from lssvc_tpu_torch.harness.results import RESULT_KEYS
from lssvc_tpu_torch.models import LSSVC, IntraSS
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.tools.synthetic import write_dataset, write_sequence

from torch_threads import share_cores

share_cores()

YUV_KEYS = {"ave_i_frame_YUV_psnr", "ave_p_frame_YUV_psnr",
            "ave_all_frame_YUV_psnr"}
REPO = Path(__file__).resolve().parents[1]


def _recording(monkeypatch, module):
    """Record each _layer_metrics result of `module`'s run_test."""
    seen = []
    real = module._layer_metrics

    def record(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(module, "_layer_metrics", record)
    return seen


def test_run_test_matches_jax(tmp_path, monkeypatch):
    h, w, frames = 104, 120, 3
    yuv = tmp_path / "seq.yuv"
    write_sequence(yuv, h, w, frames, seed=5)
    task = {"frame_num": frames, "gop_size": 3, "ratio": "x2",
            "yuv_path_el": str(yuv), "x1": {"height": h, "width": w},
            "ds_name": "synthetic", "video_path": "seq"}

    j_intra, j_video = j_init_intra_ss(192), j_init_lssvc(0)
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)  # read when JAX traces
    jax.clear_caches()
    try:
        j_seen = _recording(monkeypatch, jrunner)
        ref = jrunner.run_test(JLSSVC(j_video), JIntraSS(j_intra, channel_BL=192),
                               dict(task, bin_folder=str(tmp_path / "bins")))
    finally:
        set_od_offset_cap(None)
        jax.clear_caches()

    def np_(d):
        return {k: np.asarray(v) for k, v in d.items()}

    t_intra = IntraSS(params_from_jax(np_(j_intra), "intra_ss"), device="cpu")
    t_video = LSSVC(params_from_jax(np_(j_video), "lssvc"), device="cpu",
                    od_offset_cap=OD_OFFSET_CAP_SERVING)
    t_seen = _recording(monkeypatch, trunner)
    out = trunner.run_test(t_video, t_intra, task)

    for mine, theirs in zip(out, ref):
        assert set(mine) == set(theirs)
        assert mine["frame_type"] == theirs["frame_type"] == [0, 1, 1]
        assert mine["i_frame_num"] == 1 and mine["p_frame_num"] == 2
        for a, b in zip(mine["frame_bpp"], theirs["frame_bpp"]):
            assert abs(a - b) <= 3e-3 * abs(b), (mine["frame_bpp"],
                                                 theirs["frame_bpp"])
    # per frame and layer (BL then EL each frame)
    assert len(t_seen) == len(j_seen) == 2 * frames
    for mine, theirs in zip(t_seen, j_seen):
        assert abs(mine.bit - float(theirs.bit)) <= 3e-3 * abs(float(theirs.bit))
        for k in ("yuv_psnr", "rgb_psnr", "y_psnr", "u_psnr", "v_psnr"):
            assert abs(getattr(mine, k) - getattr(theirs, k)) <= 0.1, k
        for k in ("msssim", "rgb_msssim"):
            a, b = getattr(mine, k), getattr(theirs, k)
            assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 5e-3, k


def test_cli_writes_the_three_results(tmp_path, capsys):
    """Two frames (I P) at 128x128 on the CPU from `.pth` checkpoints of the
    port's own init.  The video checkpoint carries what the reference's
    does and the model never reads: a `module.` prefix, a Gaussian
    conditional scale table and `ms_ssim_loss.*` keys."""
    cfg = write_dataset(tmp_path / "ds", 128, 128, frames=2, gop=2, seed=7,
                        ds_name="DS")
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    sd = {"module." + k: v for k, v in
          init_lssvc(torch.Generator().manual_seed(2)).items()}
    sd["gaussian_conditional.scale_table"] = torch.ones(64)
    sd["ms_ssim_loss.window"] = torch.ones(1, 1, 11, 11)
    torch.save({"state_dict": sd}, video)
    out = tmp_path / "out"
    results = cli.main(["--test_config", str(cfg), "--i_frame_model_path",
                        str(intra), "--model_path", str(video),
                        "--output_path", str(out), "--ratios", "x2",
                        "--device", "cpu"])
    assert "dropped 1 keys the model does not read" in capsys.readouterr().out
    assert len(results) == 1
    assert [r["frame_type"] for r in results[0]] == [[0, 1]] * 3
    for layer in ("BL", "EL", "FL"):
        log = json.loads((out / f"x2_{layer}.json").read_text())
        res = log["DS"]["seq1"]["video.pth"]
        want = set(RESULT_KEYS) - (YUV_KEYS if layer == "FL" else set())
        assert set(res) == want
        assert res["i_frame_num"] == 1 and res["p_frame_num"] == 1
        assert math.isfinite(res["ave_all_frame_bpp"])
        assert res["ave_all_frame_bpp"] > 0
        assert math.isfinite(res["ave_all_frame_psnr"])


def test_checkpoints_are_held_to_the_models_keys(tmp_path):
    """A missing key or a shape that differs from the model's is an error;
    a JAX package `.npz` goes through the weight bridge."""
    spec = init_intra_ss(torch.Generator().manual_seed(0), 32)
    sd = dict(spec)
    sd.pop("h_a.0.bias")
    path = tmp_path / "intra.pth"
    torch.save(sd, path)
    with pytest.raises(KeyError, match="missing"):
        scheduler.load_intra(str(path), "cpu")
    sd = dict(spec, **{"h_a.0.bias": torch.zeros(3)})
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shapes differ"):
        scheduler.load_intra(str(path), "cpu")
    jparams = {k: np.asarray(v) for k, v in j_init_intra_ss(32).items()}
    npz = tmp_path / "intra.npz"
    np.savez(npz, __meta__step=np.asarray(3), **jparams)
    model = scheduler.load_intra(str(npz), "cpu")
    assert model.base_layer_model.N == 32
    bridged = params_from_jax(jparams, "intra_ss")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, bridged[k], rtol=0, atol=0)


@pytest.mark.parametrize("flags", [
    ["--intra_rdo"], ["--save_decoded_frame", "1"],
    ["--save_decoded_mv", "1"], ["--save_warp_frame", "1"],
    ["--save_decoded_context", "1"], ["--worker", "2"]])
def test_cli_refuses_unported_flags(tmp_path, flags):
    """`--intra_rdo` is refused; the artifact flags and `--worker` are
    ported, so the run gets past the check and on to the (missing) test
    config."""
    refused = flags == ["--intra_rdo"]
    with pytest.raises(NotImplementedError if refused else FileNotFoundError,
                       match="not ported yet" if refused else "none.json"):
        cli.main(["--test_config", str(tmp_path / "none.json"),
                  "--i_frame_model_path", "a.pth", "--model_path", "b.pth",
                  "--output_path", str(tmp_path), "--device", "cpu"] + flags)


def test_cli_runs_on_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.parse_args(["--test_config", "c", "--output_path", "o"]) \
        .device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--test_config", str(tmp_path / "none.json"),
                  "--i_frame_model_path", "a.pth", "--model_path", "b.pth",
                  "--output_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IntraSS(init_intra_ss(torch.Generator().manual_seed(0), 32))


def test_run_test_refuses_unported_task_keys(tmp_path):
    model = IntraSS(init_intra_ss(torch.Generator().manual_seed(0), 32),
                    device="cpu")
    for key in trunner.UNPORTED_TASK_KEYS:
        with pytest.raises(NotImplementedError, match=key):
            trunner.run_test(None, model, {key: True, "frame_num": 1})


def test_cli_writes_streams_that_a_fresh_decoder_rebuilds(tmp_path,
                                                         monkeypatch):
    """`--write_stream 1 --decoding_profiling 1` on the 120x104 3-frame GOP
    (I P P, padded to 128x128): a BL and an EL bin per frame, bits equal to
    8 x the files' sizes, encode and decode seconds, both layers'
    decode-profiling keys the JAX package's stage names.  Then
    `python -m lssvc_tpu_torch.decode --device cpu` in a fresh process
    rebuilds the run's EL and BL pictures byte for byte."""
    h, w, frames = 104, 120, 3
    cfg = write_dataset(tmp_path / "ds", h, w, frames=frames, gop=3, seed=5,
                        ds_name="DS")
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    torch.save(init_lssvc(torch.Generator().manual_seed(2)), video)
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = trunner.HostCopy

    def recording(tensors):  # the run's (cropped, clamped) DPB pictures
        for k in pictures:
            pictures[k].append(tensors[k].clone())
        return real_copy(tensors)

    monkeypatch.setattr(trunner, "HostCopy", recording)
    out, bins = tmp_path / "out", tmp_path / "bins"
    (res_bl, res_el, res_fl), = cli.main([
        "--test_config", str(cfg), "--i_frame_model_path", str(intra),
        "--model_path", str(video), "--output_path", str(out),
        "--ratios", "x2", "--device", "cpu", "--write_stream", "1",
        "--decoding_profiling", "1", "--stream_path", str(bins)])

    bin_dir = bins / "seq1" / "0" / "x2"
    sizes = {layer: [8 * (bin_dir / layer / f"{i}.bin").stat().st_size
                     for i in range(frames)] for layer in ("BL", "EL")}
    assert sorted(p.relative_to(bin_dir).as_posix()
                  for p in bin_dir.rglob("*")) == sorted(
        [f"{layer}/{i}.bin" for layer in ("BL", "EL")
         for i in range(frames)] + ["BL", "EL"])
    for res, bits in ((res_bl, sizes["BL"]), (res_el, sizes["EL"]),
                      (res_fl, [b + e for b, e in zip(*sizes.values())])):
        assert [round(b * res["frame_pixel_num"]) for b in res["frame_bpp"]] \
            == bits
    stages = {"BL": JDMC.DECODING_STAGES, "EL": JLSSVC.DECODING_STAGES}
    for layer in ("BL", "EL", "FL"):
        log = json.loads((out / f"x2_{layer}.json").read_text())
        res = log["DS"]["seq1"]["video.pth"]
        assert res["encoding_time"] > 0 and res["decoding_time"] > 0
        if layer == "FL":
            assert "decoding_profiling" not in res
            continue
        prof = res["decoding_profiling"]
        assert list(prof) == ["frames", "overall", *stages[layer]]
        assert prof["frames"] == 2 and prof["overall"] > 0

    dec = subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bin_dir), "--i_frame_model_path", str(intra), "--model_path",
         str(video), "--height", str(h), "--width", str(w), "--ratio", "x2",
         "--gop", "3", "--frame_num", str(frames), "--yuv_out",
         str(tmp_path / "el.yuv"), "--yuv_out_bl", str(tmp_path / "bl.yuv"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert dec.returncode == 0, dec.stderr
    for layer in ("el", "bl"):
        want = b"".join(yuv_frame(x, (0, 0, 0, 0))
                        for x in pictures[f"x_hat_{layer}"])
        assert (tmp_path / f"{layer}.yuv").read_bytes() == want, layer
