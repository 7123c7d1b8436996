"""An end-to-end RD experiment: train per-rate models, evaluate them through
the harness with real bitstreams and measure the BD-rate delta between two
precisions (the twin of the JAX package's `tools/rd_experiment.py`).

    python -m lssvc_tpu_torch.tools.rd_experiment --steps-intra 600 \
        --steps-video 1200 --lambdas 0.003 0.01 0.03 0.09 --out runs/rd
    python -m lssvc_tpu_torch.tools.rd_experiment --quick    # a small run
    python -m lssvc_tpu_torch.tools.rd_experiment --eval-only
    ... [--device cuda]

No checkpoint is published, so RD is shown on synthetic video: IntraSS
(BL 192) and LSSVC train at full width at several lambdas through
`python -m lssvc_tpu_torch.train` (one subprocess a stage, with
`--skip-if-done` and `--resume`, retried unless it fails twice with the
same last error line), then each `--modes` precision codes a held-out
synthetic sequence through `parallel/scheduler.py` `Runner.run_one` (one
`Runner` a mode, and for int8 one a checkpoint, calibrated by
`harness/calibrate.py`: no model, packed width or table of one mode
reaches another; encoder and decoder on one device).  Each rate point
prints `  <mode> lmbda=<l>: bpp=<b> rgb-psnr=<p>` (which
`lssvc_tpu_torch.tools.rd_reconstruct` parses), each mode writes
`<out>/json_<mode>/x2_{BL,EL,FL}.json`, and the run writes
`<out>/<report-name>` with the BD-rate delta of the second mode against
the first where both have 4 points or more.  Everything runs on
`--device`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..utils.launch_counts import dump_at_exit_from_env


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="runs/rd")
    p.add_argument("--lambdas", type=float, nargs="+",
                   default=[0.003, 0.01, 0.03, 0.09])
    p.add_argument("--steps-intra", type=int, default=600)
    p.add_argument("--steps-video", type=int, default=1200)
    p.add_argument("--steps-spynet", type=int, default=600,
                   help="photometric SpyNet pretrain steps (shared across "
                        "lambdas; the reference inherits a pretrained "
                        "SpyNet rather than training flow through the "
                        "untrained MV codec)")
    p.add_argument("--base-lmbda", type=float, default=0.01,
                   help="lambda for the shared base video model; per-lambda "
                        "models are short fine-tunes from it")
    p.add_argument("--steps-base", type=int, default=0,
                   help="full-stage steps for the shared base model "
                        "(0 = per-lambda from-scratch recipe)")
    p.add_argument("--steps-ft", type=int, default=600,
                   help="per-lambda cascade fine-tune steps from the base")
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--frames", type=int, default=12,
                   help="held-out eval sequence length")
    p.add_argument("--gop", type=int, default=6)
    p.add_argument("--eval-size", type=int, default=256)
    p.add_argument("--quick", action="store_true",
                   help="2 lambdas, few steps: a smoke run")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--modes", nargs="+", default=["fp32", "bf16"])
    p.add_argument("--report-name", default="rd_report.json",
                   help="report filename under --out (another one for "
                        "follow-up mode comparisons keeps the first)")
    p.add_argument("--stages", choices=["staged", "full"], default="staged",
                   help="'full' = single-stage video training")
    p.add_argument("--estimated", action="store_true",
                   help="evaluate with estimated bpp instead of real "
                        "bitstreams")
    p.add_argument("--device", default="cuda",
                   help="torch device of the training stages and the "
                        "evaluation (default cuda)")
    args = p.parse_args(argv)
    if args.quick:
        args.lambdas = [0.003, 0.03]
        args.steps_intra = 30
        args.steps_video = 40
        args.frames = 4
        args.gop = 2
        args.crop = 128
        args.eval_size = 128
    return args


def make_eval_sequence(path, n_frames, size, seed=1234):
    """The held-out synthetic YUV: the trainer's smooth textures and global
    motion (`train.SyntheticPairs`, draw for draw the JAX trainer's) plus a
    moving square, so the codec earns bits on edges and on motion."""
    from ..train import SyntheticPairs
    from ..utils.io import YUVWriter, yuv420_bytes

    gen = SyntheticPairs(size, seed=seed)
    seq = gen.next_sequences(1, n_frames)[0]  # (T, H, W, 3)
    rng = np.random.default_rng(seed + 1)
    sq = int(size * 0.15)
    x0, y0 = rng.integers(0, size - sq - n_frames * 2, 2)
    color = rng.random(3).astype(np.float32)
    for t in range(n_frames):
        seq[t, y0 + 2 * t:y0 + 2 * t + sq, x0 + 2 * t:x0 + 2 * t + sq] = color
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = YUVWriter(path, size, size)
    for t in range(n_frames):
        w.write_one_frame(yuv420_bytes(seq[t].transpose(2, 0, 1)))
    w.close()
    return path


def _run_stage(cmd, attempts=4):
    """Run a training stage, retrying only failures that may pass (a stage
    resumes from its --resume checkpoint, so a retry repeats only that
    stage).  Two failures in a row with the same last error line are
    deterministic: abort at once rather than wait and retry."""
    # a stage whose weights landed but whose process died afterwards must
    # do nothing on a retry, not train again
    cmd = list(cmd) + ["--skip-if-done"]
    prev_sig = None
    for i in range(attempts):
        print("+", " ".join(cmd), flush=True)
        # stdout (training progress) streams; stderr is kept for the check
        # and echoed on a failure
        r = subprocess.run(cmd, stderr=subprocess.PIPE, text=True)
        if r.returncode == 0:
            return
        err = (r.stderr or "").strip()
        if err:
            print(err[-4000:], flush=True)
        lines = [ln for ln in err.splitlines() if ln.strip()]
        sig = (r.returncode, lines[-1] if lines else "")
        if sig == prev_sig:
            raise RuntimeError(
                f"stage failed twice with the same error (deterministic; "
                f"not retrying): {sig[1]!r}\ncmd: {cmd}")
        prev_sig = sig
        wait = 60 * (i + 1)
        print(f"stage failed (rc={r.returncode}); "
              f"retry {i + 1}/{attempts - 1} in {wait}s", flush=True)
        time.sleep(wait)
    raise RuntimeError(f"stage failed after {attempts} attempts: {cmd}")


def _train_cmd(device):
    """The trainer's command up to its stage flags."""
    return [sys.executable, "-m", "lssvc_tpu_torch.train", "--device",
            device]


def train_base(args, out_dir):
    """The lambda-independent stages: SpyNet's photometric pretraining,
    then the staged recipe at --base-lmbda.  Per-lambda models fine-tune
    from the returned checkpoint (`train_models`), so the long stages run
    once, not once a rate point."""
    train = _train_cmd(args.device)
    lm = str(args.base_lmbda)
    spynet_ckpt = os.path.join(out_dir, f"spynet_step{args.steps_spynet}.npz")
    s_mv = max(args.steps_base // 8, 1)
    s_full = args.steps_base
    s_casc = max(args.steps_base // 2, 1)
    mv_ckpt = os.path.join(out_dir, f"base_mv_step{s_mv}.npz")
    full_ckpt = os.path.join(out_dir, f"base_full_step{s_full}.npz")
    base_ckpt = os.path.join(out_dir, f"base_cascade_step{s_casc}.npz")
    common = ["--crop", str(args.crop), "--batch-per-device", str(args.batch)]
    # each stage is gated on its own output (or a later stage's): a
    # relaunch after a failure skips the stages that finished
    if not os.path.exists(spynet_ckpt):
        _run_stage([*train, "--stage", "spynet",
                    "--steps", str(args.steps_spynet),
                    "--out", os.path.join(out_dir, "spynet"),
                    "--save-every", str(args.steps_spynet)] + common)
    if not any(os.path.exists(p) for p in (mv_ckpt, full_ckpt, base_ckpt)):
        _run_stage([*train, "--stage", "mv", "--steps", str(s_mv),
                    "--lmbda", lm, "--resume", spynet_ckpt,
                    "--out", os.path.join(out_dir, "base_mv"),
                    "--save-every", str(s_mv)] + common)
    if not any(os.path.exists(p) for p in (full_ckpt, base_ckpt)):
        _run_stage([*train, "--stage", "full", "--steps", str(s_full),
                    "--lmbda", lm, "--resume", mv_ckpt,
                    "--out", os.path.join(out_dir, "base_full"),
                    "--save-every", str(s_full),
                    "--lr-decay-steps", str(s_full)] + common)
    if not os.path.exists(base_ckpt):
        _run_stage([*train, "--stage", "cascade", "--frames", "3",
                    "--steps", str(s_casc), "--lmbda", lm,
                    "--resume", full_ckpt,
                    "--out", os.path.join(out_dir, "base_cascade"),
                    "--save-every", str(s_casc),
                    "--lr-decay-steps", str(s_casc)] + common)
    if not os.path.exists(base_ckpt):
        raise RuntimeError(
            f"base cascade stage exited 0 but {base_ckpt} was not written "
            f"(check the stage's resume log line)")
    return base_ckpt


def _tag(lmbda):
    return f"l{lmbda:g}".replace(".", "p")


def train_models(args, lmbda, out_dir, base_ckpt=None):
    """IntraSS, then the LSSVC recipe, for one rate point: (intra, video)
    checkpoints.  With base_ckpt (the shared-base recipe) the video model
    is a short cascade fine-tune; otherwise the staged recipe (or with
    `--stages full` one full stage) trains it from scratch."""
    tag = _tag(lmbda)
    intra_ckpt = os.path.join(out_dir, f"intra_{tag}_step{args.steps_intra}.npz")
    train = _train_cmd(args.device)
    run = _run_stage
    if base_ckpt is not None:
        video_ckpt = os.path.join(
            out_dir, f"video_{tag}_ft_step{args.steps_ft}.npz")
    else:
        video_final_steps = args.steps_video
        final_stage = "cascade" if args.stages == "staged" else "full"
        video_ckpt = os.path.join(
            out_dir, f"video_{tag}_{final_stage}_step{video_final_steps}.npz")

    if not os.path.exists(intra_ckpt):
        run([*train, "--loss", "intra", "--steps", str(args.steps_intra),
             "--lmbda", str(lmbda), "--crop", str(args.crop),
             "--batch-per-device", str(args.batch),
             "--out", os.path.join(out_dir, f"intra_{tag}"),
             "--save-every", str(args.steps_intra),
             "--lr-decay-steps", str(args.steps_intra)])
    if base_ckpt is not None:
        if not os.path.exists(video_ckpt):
            run([*train, "--stage", "cascade", "--frames", "3",
                 "--steps", str(args.steps_ft),
                 "--lmbda", str(lmbda), "--crop", str(args.crop),
                 "--batch-per-device", str(args.batch),
                 "--resume", base_ckpt,
                 "--out", os.path.join(out_dir, f"video_{tag}_ft"),
                 "--save-every", str(args.steps_ft),
                 "--lr-decay-steps", str(args.steps_ft)])
        return intra_ckpt, video_ckpt
    if not os.path.exists(video_ckpt) and args.stages == "full":
        run([*train, "--stage", "full", "--steps", str(video_final_steps),
             "--lmbda", str(lmbda), "--crop", str(args.crop),
             "--batch-per-device", str(args.batch),
             "--out", os.path.join(out_dir, f"video_{tag}_full"),
             "--save-every", str(video_final_steps),
             "--lr-decay-steps", str(video_final_steps)])
    elif not os.path.exists(video_ckpt):
        # stage 1: the MV subnets alone (everything else frozen), short
        s1 = max(args.steps_video // 4, 1)
        run([*train, "--stage", "mv", "--steps", str(s1),
             "--lmbda", str(lmbda), "--crop", str(args.crop),
             "--batch-per-device", str(args.batch),
             "--out", os.path.join(out_dir, f"video_{tag}_mv"),
             "--save-every", str(s1)])
        # stage 2: single-frame RD
        s2 = max(args.steps_video // 2, 1)
        run([*train, "--stage", "full", "--steps", str(s2),
             "--lmbda", str(lmbda), "--crop", str(args.crop),
             "--batch-per-device", str(args.batch),
             "--resume", os.path.join(out_dir, f"video_{tag}_mv_step{s1}.npz"),
             "--out", os.path.join(out_dir, f"video_{tag}_full"),
             "--save-every", str(s2), "--lr-decay-steps", str(s2)])
        # stage 3: the multi-frame cascade
        run([*train, "--stage", "cascade", "--frames", "3",
             "--steps", str(video_final_steps),
             "--lmbda", str(lmbda), "--crop", str(args.crop),
             "--batch-per-device", str(args.batch),
             "--resume", os.path.join(out_dir, f"video_{tag}_full_step{s2}.npz"),
             "--out", os.path.join(out_dir, f"video_{tag}_cascade"),
             "--save-every", str(video_final_steps),
             "--lr-decay-steps", str(video_final_steps)])
    return intra_ckpt, video_ckpt


def eval_ckpts(args, out_dir) -> dict:
    """`--eval-only`: lambda -> the (intra, video) checkpoints a training
    run with these flags wrote."""
    ckpts = {}
    for lmbda in args.lambdas:
        tag = _tag(lmbda)
        if args.steps_base > 0:
            video = f"video_{tag}_ft_step{args.steps_ft}.npz"
        else:
            stage = "cascade" if args.stages == "staged" else "full"
            video = f"video_{tag}_{stage}_step{args.steps_video}.npz"
        ckpts[lmbda] = (
            os.path.join(out_dir, f"intra_{tag}_step{args.steps_intra}.npz"),
            os.path.join(out_dir, video))
    return ckpts


def evaluate(args, ckpts, yuv_dir, mode, out_dir):
    """Every rate point through the harness (real bitstreams unless
    `--estimated`) in one precision: the FL RD points [(bpp, psnr), ...].
    The mode builds its own models (a `Runner` of its own; int8 one a
    checkpoint with its own calibration table), so nothing of an earlier
    mode is served."""
    import torch

    from ..checkpoint import load_params
    from ..harness.calibrate import calibrate_video
    from ..harness.results import filter_dict
    from ..parallel.scheduler import Runner
    from ..utils.platform import resolve_device

    device = resolve_device(args.device)
    size = args.eval_size
    points = []
    logs = {"BL": {"SYN": {"eval": {}}}, "EL": {"SYN": {"eval": {}}},
            "FL": {"SYN": {"eval": {}}}}
    runner = None if mode == "int8" else Runner(device, None, precision=mode)
    for i, (lmbda, (intra_ckpt, video_ckpt)) in enumerate(ckpts.items()):
        if mode == "int8":
            # activation ranges depend on the trained weights: a table a
            # checkpoint, and models built with it
            vparams, _ = load_params(video_ckpt, "lssvc")
            table = calibrate_video(vparams, size=min(args.eval_size, 256),
                                    frames=2, device=device)
            runner = Runner(device, None, precision="int8", int8_table=table)
        task = {
            "i_frame_model_path": intra_ckpt,
            "video_model_path": video_ckpt,
            "write_stream": not args.estimated,
            "dataset_path": yuv_dir,
            "video_path": "eval",
            "ds_name": "SYN",
            "ratio": "x2",
            "x1": {"width": size, "height": size},
            "gop": args.gop,
            "frame_num": args.frames,
            "stream_path": os.path.join(out_dir, f"bins_{mode}_{i}"),
            "model_idx": i,
        }
        res_bl, res_el, res_fl = runner.run_one(task)
        ckpt_name = os.path.basename(video_ckpt)
        for layer, res in (("BL", res_bl), ("EL", res_el), ("FL", res_fl)):
            logs[layer]["SYN"]["eval"][ckpt_name] = filter_dict(res)
        points.append((res_fl["ave_all_frame_bpp"],
                       res_fl["ave_all_frame_rgb_psnr"]))
        print(f"  {mode} lmbda={lmbda:g}: bpp={points[-1][0]:.4f} "
              f"rgb-psnr={points[-1][1]:.2f}", flush=True)
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the result JSONs in the reference's {ratio}_{BL,EL,FL}.json nesting
    json_dir = os.path.join(out_dir, f"json_{mode}")
    os.makedirs(json_dir, exist_ok=True)
    for layer, log in logs.items():
        with open(os.path.join(json_dir, f"x2_{layer}.json"), "w") as f:
            json.dump(log, f, indent=2)
    return points


def main(argv=None):
    args = parse_args(argv)
    dump_at_exit_from_env()
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    yuv_dir = os.path.join(out_dir, "eval_ds")
    make_eval_sequence(os.path.join(yuv_dir, "eval", "x1.yuv"),
                       args.frames, args.eval_size)

    base_ckpt = None
    if args.steps_base > 0 and not args.eval_only:
        t0 = time.time()
        base_ckpt = train_base(args, out_dir)
        print(f"trained shared base in {time.time() - t0:.0f}s", flush=True)
    if args.eval_only:
        ckpts = eval_ckpts(args, out_dir)
    else:
        ckpts = {}
        for lmbda in args.lambdas:
            t0 = time.time()
            ckpts[lmbda] = train_models(args, lmbda, out_dir, base_ckpt)
            print(f"trained lmbda={lmbda:g} in {time.time() - t0:.0f}s",
                  flush=True)

    curves = {}
    for mode in args.modes:
        print(f"=== evaluating mode {mode}", flush=True)
        curves[mode] = evaluate(args, ckpts, yuv_dir, mode, out_dir)

    report = {"lambdas": args.lambdas, "curves": curves}
    # the curves first: bd_rate raises on PSNR ranges that do not overlap,
    # which must not lose the evaluation
    report_path = os.path.join(out_dir, args.report_name)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    if len(args.modes) == 2 and all(len(c) >= 4 for c in curves.values()):
        from ..harness.bd_rate import bd_rate

        a, b = (curves[m] for m in args.modes)
        try:
            delta = bd_rate([p[0] for p in a], [p[1] for p in a],
                            [p[0] for p in b], [p[1] for p in b])
        except ValueError as e:
            print(f"BD-rate fit failed ({e}); curves-only report kept")
        else:
            report["bd_rate_delta_pct"] = delta
            print(f"BD-rate {args.modes[1]} vs {args.modes[0]}: {delta:+.3f}%")
            with open(report_path, "w") as f:
                json.dump(report, f, indent=2)
    print(f"report -> {report_path}")


if __name__ == "__main__":
    main()
