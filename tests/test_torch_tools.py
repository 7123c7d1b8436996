"""The four root tools' twins (`python -m lssvc_tpu_torch.tools.<name>`)
against the root tools, on the CPU.

- rd_experiment: the held-out sequence byte-equal to the root tool's; the
  stage commands of both recipes and `--eval-only`'s checkpoint names the
  root tool's (but `-m lssvc_tpu_torch.train --device`); one real run
  (one lambda, `--stages full`, 1 step a stage at crop 128, the trainer's
  smallest, eval 64, 2 frames, fp32 and bf16) whose lines, JSONs and
  report the root tools read, and whose per-mode numbers `--modes bf16
  fp32` repeats exactly.  Its two full-width checkpoints (about 0.5 GB
  each with their optimizer state) are deleted when the module ends.
- rd_reconstruct: `tests/test_tools.py`'s cases on both tools, and the
  twin's report equal to the root tool's on one log.
- chain_probe: per-frame PSNRs within 0.05 dB of the root tool's on one
  random-init checkpoint pair (at 128x128, the smallest size IntraNoAR's
  hyperprior takes), and the cliff rule with its exit code.
- ref_scale_eval: `synth_1080p` byte-equal to the root tool's; the config
  and the printed command.

The root tools are loaded from their paths with importlib (JAX on the
CPU, as `tests/conftest.py` pins it).
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lssvc_tpu_torch import checkpoint
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.tools import chain_probe, rd_experiment, ref_scale_eval

from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]
LAMBDA = 0.01
PSNR_TOL_DB = 0.05  # chain_probe: the same frames in two frameworks


def _root(name):
    """The root tool tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name, *argv, check=True):
    res = subprocess.run(
        [sys.executable, "-m", f"lssvc_tpu_torch.tools.{name}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if check:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


# ---------------------------------------------------------------------------
# rd_experiment

def test_eval_sequence_bytes_equal_the_root_tool(tmp_path):
    _root("rd_experiment").make_eval_sequence(
        str(tmp_path / "root" / "x1.yuv"), 3, 64)
    rd_experiment.make_eval_sequence(str(tmp_path / "port" / "x1.yuv"), 3, 64)
    assert (tmp_path / "port" / "x1.yuv").stat().st_size == 3 * 64 * 64 * 3 // 2
    assert filecmp.cmp(tmp_path / "root" / "x1.yuv",
                       tmp_path / "port" / "x1.yuv", shallow=False)


def _stage_commands(mod, args, out, recipe):
    """The training commands `mod`'s recipe runs, `_run_stage` recording
    them in place of running them."""
    cmds = []
    real = mod._run_stage
    mod._run_stage = lambda cmd, attempts=4: cmds.append(list(cmd))
    try:
        base = mod.train_base(args, out) if recipe == "base" else None
        mod.train_models(args, LAMBDA, out, base)
    except RuntimeError as err:  # the base stage's missing checkpoint
        assert "was not written" in str(err)
    finally:
        mod._run_stage = real
    return cmds


@pytest.mark.parametrize("recipe, flags", [
    ("base", ["--steps-base", "16", "--steps-ft", "3"]),
    ("staged", ["--steps-video", "8"]),
    ("full", ["--stages", "full", "--steps-video", "8"])])
def test_stage_commands_are_the_root_tool_s(tmp_path, recipe, flags):
    """Every stage command of a recipe is the root tool's, apart from the
    trainer (`-m lssvc_tpu_torch.train` and `--device`)."""
    args = rd_experiment.parse_args(["--steps-intra", "5", "--crop", "128",
                                     "--device", "cpu", *flags])
    out = str(tmp_path)
    root = _stage_commands(_root("rd_experiment"), args, out, recipe)
    port = _stage_commands(rd_experiment, args, out, recipe)
    prefix = [sys.executable, "-m", "lssvc_tpu_torch.train", "--device",
              "cpu"]
    assert len(port) == len(root) >= 2
    for p, r in zip(port, root):
        assert p[:5] == prefix and r[1].endswith("train.py")
        assert p[5:] == r[2:]


def _eval_only_ckpts(mod, argv, monkeypatch, tmp_path):
    """The checkpoints `main(--eval-only)` evaluates, `evaluate` recording
    them."""
    seen = []

    def evaluate(args, ckpts, yuv_dir, mode, out_dir):
        seen.append(dict(ckpts))
        return [(0.1, 30.0)] * len(ckpts)

    monkeypatch.setattr(mod, "evaluate", evaluate)
    monkeypatch.setattr(sys, "argv", ["rd_experiment", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main(argv) if mod is rd_experiment else mod.main()
    return seen


@pytest.mark.parametrize("flags", [[], ["--steps-base", "40"],
                                   ["--stages", "full"]])
def test_eval_only_reads_the_root_tool_s_checkpoint_names(
        tmp_path, monkeypatch, flags):
    argv = ["--eval-only", "--out", str(tmp_path), "--frames", "2",
            "--eval-size", "64", "--modes", "fp32", *flags]
    root = _eval_only_ckpts(_root("rd_experiment"), argv, monkeypatch,
                            tmp_path)
    port = _eval_only_ckpts(rd_experiment, argv + ["--device", "cpu"],
                            monkeypatch, tmp_path)
    assert port == root and len(port[0]) == 4


RD_ARGV = ["--lambdas", str(LAMBDA), "--stages", "full", "--steps-intra",
           "1", "--steps-video", "1", "--crop", "128", "--eval-size", "64",
           "--frames", "2", "--device", "cpu"]
POINT = re.compile(r"^  (\w+) lmbda=([0-9.e-]+): bpp=([0-9.]+) "
                   r"rgb-psnr=([0-9.]+)$")


@pytest.fixture(scope="module")
def rd_run(tmp_path_factory):
    """One real run in this process: the trainer's stages (one step each:
    `--scan-steps 1` added, the trainer drawing 8 a chunk by default),
    then fp32 and bf16; its printed log and output directory.  The
    checkpoints are deleted at the module's end."""
    out = tmp_path_factory.mktemp("rd")
    real = rd_experiment._run_stage

    def one_step(cmd, attempts=4):
        real(list(cmd) + ["--scan-steps", "1"], attempts)

    rd_experiment._run_stage = one_step
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rd_experiment.main(["--out", str(out), "--modes", "fp32", "bf16",
                                *RD_ARGV])
    finally:
        rd_experiment._run_stage = real
    yield buf.getvalue(), out
    for f in out.glob("*.npz"):
        f.unlink()


def test_rd_experiment_run_writes_what_the_root_tools_read(rd_run):
    log, out = rd_run
    points = [POINT.match(line).groups() for line in log.splitlines()
              if POINT.match(line)]
    assert [(m, float(lm)) for m, lm, _, _ in points] == \
        [("fp32", LAMBDA), ("bf16", LAMBDA)]
    assert sorted(p.name for p in out.glob("*.npz")) == [
        "intra_l0p01_step1.npz", "intra_l0p01_step1.state.npz",
        "video_l0p01_full_step1.npz", "video_l0p01_full_step1.state.npz"]
    report = json.loads((out / "rd_report.json").read_text())
    assert report["lambdas"] == [LAMBDA]
    for mode, _, bpp, psnr in points:
        (got,) = report["curves"][mode]
        # the line prints the report's numbers at 4 and 2 decimals
        assert f"{got[0]:.4f}" == bpp and f"{got[1]:.2f}" == psnr
        assert got[0] > 0 and got[1] > 0
        for layer in ("BL", "EL", "FL"):
            res = json.loads((out / f"json_{mode}" / f"x2_{layer}.json")
                             .read_text())
            (entry,) = res["SYN"]["eval"].values()
            assert "ave_all_frame_bpp" in entry
        assert any((out / f"bins_{mode}_0").rglob("*.bin"))
    md = subprocess.run([sys.executable, str(REPO / "tools" / "rd_report.py"),
                         str(out / "rd_report.json")], capture_output=True,
                        text=True, timeout=60)
    assert md.returncode == 0, md.stderr
    assert f"| {LAMBDA:g} |" in md.stdout


def test_rd_experiment_modes_do_not_depend_on_their_order(rd_run):
    """`python -m ...rd_experiment --eval-only --modes bf16 fp32` on the
    same checkpoints: each mode's point equal to the first run's, bit for
    bit (no model, packed width or table of one mode reaches the next)."""
    _, out = rd_run
    res = _port("rd_experiment", "--out", str(out), "--eval-only",
                "--modes", "bf16", "fp32", "--report-name", "reversed.json",
                *RD_ARGV)
    assert "=== evaluating mode bf16" in res.stdout
    first = json.loads((out / "rd_report.json").read_text())["curves"]
    again = json.loads((out / "reversed.json").read_text())["curves"]
    assert list(again) == ["bf16", "fp32"]
    assert again == first


def test_rd_reconstruct_rebuilds_the_run_s_report(rd_run, tmp_path):
    """rd_reconstruct on the run's log: the run's curves."""
    log, out = rd_run
    path = tmp_path / "rd_log.txt"
    path.write_text(log)
    rebuilt = tmp_path / "rebuilt.json"
    _port("rd_reconstruct", str(path), "--out", str(rebuilt), "--lambdas",
          str(LAMBDA), "--device", "cpu")
    run = json.loads((out / "rd_report.json").read_text())
    got = json.loads(rebuilt.read_text())
    for mode, pts in run["curves"].items():
        (bpp, psnr), = got["curves"][mode]
        assert abs(bpp - pts[0][0]) <= 5e-5 and abs(psnr - pts[0][1]) <= 5e-3


# ---------------------------------------------------------------------------
# rd_reconstruct: tests/test_tools.py's cases on both tools

def _reconstruct(tool, *argv):
    if tool == "root":
        return subprocess.run(
            [sys.executable, str(REPO / "tools" / "rd_reconstruct.py"),
             *argv], capture_output=True, text=True, cwd=REPO, timeout=120)
    return _port("rd_reconstruct", *argv, "--device", "cpu", check=False)


def _full_log(path):
    lines = ["=== evaluating mode fp32",
             # a relaunch printed the first lambda twice, the stale value
             # first: the last occurrence wins
             "  fp32 lmbda=0.003: bpp=0.9000 rgb-psnr=11.00"]
    pts = {0.003: (0.10, 30.0), 0.01: (0.20, 33.0), 0.03: (0.40, 36.0),
           0.09: (0.80, 39.0)}
    for lm, (b, p) in pts.items():
        lines.append(f"  fp32 lmbda={lm:g}: bpp={b:.4f} rgb-psnr={p:.2f}")
    for lm, (b, p) in pts.items():  # bf16 0.05 dB worse
        lines.append(f"  bf16 lmbda={lm:g}: bpp={b:.4f} "
                     f"rgb-psnr={p - 0.05:.2f}")
    lines.append("step 40: loss=1.0 bpp=0.5 mse_el=0.1 (2.0 frames/s)")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("tool", ["root", "port"])
def test_rd_reconstruct_recovers_points_and_bd(tmp_path, tool):
    log = tmp_path / "rd_log.txt"
    _full_log(log)
    out = tmp_path / "rd_report.json"
    r = _reconstruct(tool, str(log), "--out", str(out))
    assert r.returncode == 0, r.stderr
    rep = json.loads(out.read_text())
    assert rep["curves"]["fp32"][0] == [0.10, 30.0]  # not the stale line
    assert len(rep["curves"]["fp32"]) == 4
    assert len(rep["curves"]["bf16"]) == 4
    # bf16 loses a constant 0.05 dB, so its BD-rate against fp32 is > 0
    assert rep["bd_rate_delta_pct"] > 0
    # it refuses to overwrite a report without --force
    assert _reconstruct(tool, str(log), "--out", str(out)).returncode != 0


@pytest.mark.parametrize("tool", ["root", "port"])
def test_rd_reconstruct_partial_mode(tmp_path, tool):
    log = tmp_path / "rd_log.txt"
    log.write_text("  fp32 lmbda=0.003: bpp=0.1000 rgb-psnr=30.00\n"
                   "  fp32 lmbda=0.01: bpp=0.2000 rgb-psnr=33.00\n")
    out = tmp_path / "rep.json"
    r = _reconstruct(tool, str(log), "--out", str(out))
    assert r.returncode == 0, r.stderr
    rep = json.loads(out.read_text())
    assert list(rep["curves"]) == ["fp32"]
    assert "bd_rate_delta_pct" not in rep  # both modes need 4+ points


def test_rd_reconstruct_report_equals_the_root_tool_s(tmp_path):
    log = tmp_path / "rd_log.txt"
    _full_log(log)
    reports = []
    for tool in ("root", "port"):
        out = tmp_path / f"{tool}.json"
        assert _reconstruct(tool, str(log), "--out", str(out)).returncode == 0
        reports.append(json.loads(out.read_text()))
    assert reports[0] == reports[1]


# ---------------------------------------------------------------------------
# chain_probe

FRAME_LINE = re.compile(r"^frame (\d+): EL rgb psnr ([0-9.-]+) dB$")


def _psnrs(text):
    return [float(m.group(2)) for m in map(FRAME_LINE.match,
                                           text.splitlines()) if m]


def test_chain_probe_psnrs_match_the_root_tool(tmp_path, monkeypatch):
    """One random-init checkpoint pair written by the port's checkpoint.py,
    3 frames at 128x128 in fp32: each frame's PSNR within 0.05 dB of the
    root tool's (JAX on the CPU), the same exit code."""
    video, intra = tmp_path / "video.npz", tmp_path / "intra.npz"
    checkpoint.save_params(str(video),
                           init_lssvc(torch.Generator().manual_seed(2)),
                           "lssvc")
    checkpoint.save_params(str(intra), init_intra_ss(
        torch.Generator().manual_seed(1), 192), "intra_ss")
    yuv = tmp_path / "x1.yuv"
    rd_experiment.make_eval_sequence(str(yuv), 3, 128)
    argv = ["--video", str(video), "--intra", str(intra), "--yuv", str(yuv),
            "--size", "128", "--frames", "3", "--precision", "fp32"]
    port = _port("chain_probe", *argv, "--device", "cpu", check=False)
    monkeypatch.setattr(sys, "argv", ["chain_probe", *argv])
    buf, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(buf):
            _root("chain_probe").main()
    except SystemExit as exit_:
        code = exit_.code
    finally:  # 0.25 GB of weights
        video.unlink()
        intra.unlink()
    got, ref = _psnrs(port.stdout), _psnrs(buf.getvalue())
    assert len(got) == len(ref) == 3, port.stderr[-2000:]
    assert max(abs(a - b) for a, b in zip(got, ref)) <= PSNR_TOL_DB
    assert port.returncode == code


@pytest.mark.parametrize("psnrs, is_cliff", [
    ([30.0, 19.0, 8.0], True), ([30.0, 19.0, 11.5], False),
    ([30.0, 19.0, 11.3], True), ([30.0, 19.0], False),
    ([30.0, 19.0, 18.5, 4.0], False)])
def test_chain_probe_cliff_rule(monkeypatch, capsys, psnrs, is_cliff):
    """P2 below 0.6 x P1's dB is a cliff (exit code 1), at three frames or
    more; later frames are not read."""
    assert chain_probe.cliff(psnrs) is is_cliff
    monkeypatch.setattr(chain_probe, "models", lambda *a: (None, None))
    monkeypatch.setattr(chain_probe, "read_frames", lambda *a: [])
    monkeypatch.setattr(chain_probe, "probe", lambda *a: list(psnrs))
    argv = ["--video", "v.npz", "--intra", "i.npz", "--device", "cpu"]
    if is_cliff:
        with pytest.raises(SystemExit) as exit_:
            chain_probe.main(argv)
        assert exit_.value.code == 1
        assert "STEADY-STATE CLIFF" in capsys.readouterr().out
    else:
        chain_probe.main(argv)
        assert capsys.readouterr().out.strip().endswith("chain healthy")


# ---------------------------------------------------------------------------
# ref_scale_eval

def test_synth_1080p_bytes_equal_the_root_tool(tmp_path):
    _root("ref_scale_eval").synth_1080p(str(tmp_path / "root.yuv"), 4, h=96,
                                        w=128)
    ref_scale_eval.synth_1080p(str(tmp_path / "port.yuv"), 4, h=96, w=128)
    assert (tmp_path / "port.yuv").stat().st_size == 4 * 96 * 128 * 3 // 2
    assert filecmp.cmp(tmp_path / "root.yuv", tmp_path / "port.yuv",
                       shallow=False)


def test_ref_scale_eval_config_and_command(tmp_path, monkeypatch):
    """`python -m ...ref_scale_eval --frames 2`: the 1080p YUV, the root
    tool's config, and the root tool's command on the port's CLI with
    `--device`."""
    out = tmp_path / "port"
    res = _port("ref_scale_eval", "--out", str(out), "--frames", "2",
                "--gop", "2", "--device", "cpu")
    yuv = out / "ds" / "seq1080" / "x1.yuv"
    assert yuv.stat().st_size == 2 * 1920 * 1080 * 3 // 2
    root_out = tmp_path / "root"
    (root_out / "ds" / "seq1080").mkdir(parents=True)
    shutil.copy(yuv, root_out / "ds" / "seq1080" / "x1.yuv")  # not redrawn
    monkeypatch.setattr(sys, "argv", ["ref_scale_eval", "--out",
                                      str(root_out), "--frames", "2",
                                      "--gop", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _root("ref_scale_eval").main()
    cfg = json.loads((out / "config.json").read_text())
    root_cfg = json.loads((root_out / "config.json").read_text())
    root_cfg["SYN1080"]["base_path"] = str(out / "ds")
    assert cfg == root_cfg
    cmd = res.stdout[res.stdout.index("run:"):].strip()
    root_cmd = buf.getvalue()[buf.getvalue().index("run:"):].strip()
    want = root_cmd.replace("python test.py", "python -m lssvc_tpu_torch.test")
    assert cmd == want.replace(str(root_out), str(out)) + \
        " \\\n  --device cpu"
    assert os.path.exists(yuv)
