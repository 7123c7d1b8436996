"""The port's analysis and orchestration twins against the JAX package's:
`harness/bd_rate.py`, `compare_rd.py` (the root script), `harness/jobs.py`
and `submit_test.py`.

The RD tables are compared on result JSONs that the port's CLI writes on
the CPU: four IntraSS checkpoints of the port's init (BL 32) as four rate
points, all-intra, one 128x128 frame at x2.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lssvc_tpu.harness import bd_rate as jbd
from lssvc_tpu.harness import jobs as jjobs
from lssvc_tpu_torch import compare_rd, submit_test
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.harness import bd_rate as tbd
from lssvc_tpu_torch.harness import jobs as tjobs
from lssvc_tpu_torch.models.init import init_intra_ss
from lssvc_tpu_torch.tools.synthetic import write_dataset

from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", range(3))
def test_bd_metrics_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    rate_a = np.sort(rng.uniform(0.02, 0.4, 4))
    psnr_a = np.sort(rng.uniform(28, 38, 4))
    rate_t = rate_a * rng.uniform(0.7, 1.1, 4)
    psnr_t = psnr_a + rng.normal(0, 0.3, 4)
    for fn in ("bd_rate", "bd_psnr"):
        out = getattr(tbd, fn)(rate_a, psnr_a, rate_t, psnr_t)
        ref = getattr(jbd, fn)(rate_a, psnr_a, rate_t, psnr_t)
        assert abs(out - ref) <= 1e-12 * max(1.0, abs(ref)), (fn, out, ref)
    # a curve against itself is 0
    assert tbd.bd_rate(rate_a, psnr_a, rate_a, psnr_a) == pytest.approx(
        0.0, abs=1e-9)
    with pytest.raises(ValueError, match="overlap"):
        tbd.bd_rate(rate_a, psnr_a, rate_a, psnr_a + 20)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's CLI, all-intra over four checkpoints: x2_{BL,EL,FL}.json."""
    d = tmp_path_factory.mktemp("rd")
    cfg = write_dataset(d / "ds", 128, 128, frames=1, gop=1, seed=2,
                        ds_name="DS")
    ckpts = []
    for i in range(4):
        ckpts.append(str(d / f"q{i}.pth"))
        torch.save(init_intra_ss(torch.Generator().manual_seed(10 + i), 32),
                   ckpts[-1])
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", *ckpts,
              "--force_intra", "1", "--output_path", str(d / "out"),
              "--ratios", "x2", "--device", "cpu"])
    return d / "out"


@pytest.mark.parametrize("extra", [[], ["--per-sequence", "--metric", "psnr"],
                                   ["--anchor", "EL", "--metric", "msssim"]])
def test_compare_rd_twin_prints_the_root_scripts_tables(results, extra):
    """Both CLIs in subprocesses (LAPACK writes its own warnings to the
    process's stdout when a fit is degenerate)."""
    args = ["--results", f"FL={results / 'x2_FL.json'}",
            f"EL={results / 'x2_EL.json'}", f"BL={results / 'x2_BL.json'}"]
    data = json.loads((results / "x2_FL.json").read_text())
    assert len(data["DS"]["seq1"]) == 4  # four rate points

    def run(*cmd):
        res = subprocess.run([sys.executable, *cmd, *args, *extra], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout

    out = run("-m", "lssvc_tpu_torch.compare_rd")
    assert out == run("compare_rd.py")
    assert "BD-rate vs" in out


def test_compare_rd_twin_bd_of_a_result_set_against_itself_is_zero(
        results, capsys):
    fl = results / "x2_FL.json"
    assert compare_rd.main(["--results", f"A={fl}", f"B={fl}"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if "| mean" in ln]
    assert len(rows) == 1 and rows[0].split() == [
        "B", "DS:", "+0.0", "|", "mean", "+0.0"], rows


def test_compare_rd_twin_plot_without_matplotlib(results, tmp_path,
                                                 monkeypatch, capsys):
    """--plot with no matplotlib: the tables print, a clear message, exit
    2; matplotlib is imported only when it draws."""
    monkeypatch.setattr(compare_rd.importlib.util, "find_spec",
                        lambda name: None)
    fl = results / "x2_FL.json"
    png = tmp_path / "rd.png"
    assert compare_rd.main(["--results", f"A={fl}", "--plot", str(png)]) == 2
    captured = capsys.readouterr()
    assert "RD points" in captured.out
    assert "matplotlib is not installed" in captured.err
    assert not png.exists()


def _job(tmp_path):
    cfg = {"image_models": ["i1.pth", "i2.pth"],
           "video_models": ["v1.pth", "v2.pth"], "experiment_name": "E",
           "write_stream": True, "worker": 2}
    path = tmp_path / "job.json"
    path.write_text(json.dumps(cfg))
    return path


def test_jobs_command_names_the_ports_cli(tmp_path):
    cfg = tjobs.JobConfig.from_json(str(_job(tmp_path)))
    cmd = tjobs.build_test_command(cfg, force_intra_period=32)
    assert cmd.startswith("python3 -m lssvc_tpu_torch.test ")
    ref = jjobs.build_test_command(jjobs.JobConfig.from_json(
        str(_job(tmp_path))), force_intra_period=32)
    # the same flags as the JAX package's command, behind the port's CLI
    assert cmd.split()[3:] == ref.split()[2:]
    assert tjobs.build_intra_command(cfg).endswith(" --force_intra 1")
    # the command's flags parse in the port's CLI
    args = cli.parse_args(cmd.split()[3:])
    assert args.i_frame_model_path == ["i1.pth", "i2.pth"]
    assert args.force_intra_period == 32 and args.write_stream
    assert tjobs.run_commands(["exit 3", "true"], workers=2) == [3, 0]


def test_submit_test_dry_run_prints_the_command(tmp_path, capsys):
    job = _job(tmp_path)
    assert submit_test.main(["--job-config", str(job), "--intra-period", "12",
                             "--dry-run"]) == 0
    cmd = tjobs.build_test_command(tjobs.JobConfig.from_json(str(job)), 12)
    assert capsys.readouterr().out.strip() == cmd
    assert "lssvc_tpu_torch.test" in cmd
