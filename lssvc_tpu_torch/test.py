"""Evaluation CLI of the port (the JAX package's `test.py`): the same flags,
the same test-config JSON schema and the same `{ratio}_{BL,EL,FL}.json`
results, with estimated bits or, with `--write_stream 1`, real bitstreams.

    python -m lssvc_tpu_torch.test --test_config cfg.json \\
        --i_frame_model_path intra.pth --model_path video.pth \\
        --output_path out --ratios x2 [--device cpu] \\
        [--write_stream 1 --stream_path bins [--decoding_profiling 1]] \\
        [--intra_rdo [--intra_lmbda 0.01 ...]] \\
        [--worker 2] [--save_decoded_frame 1] [--save_decoded_mv 1] \\
        [--save_warp_frame 1] [--save_decoded_context 1]

Runs on `cuda` unless `--device` says otherwise, in `--precision` fp32
(the parity mode; default), high (TF32 convs and matmuls on the card),
bf16 (bf16 conv operands and outputs, f32 accumulation) or int8 (bf16 with
the s8 convolution at the calibrated packed sites, at packed width 2; it
needs `--int8_calib table.json`, from `python -m
lssvc_tpu_torch.tools.int8_calibrate`).  Streams go to
`<stream_path>/<sequence>/<model_idx>/<ratio>/{BL,EL}/<frame>.bin`, and
`python -m lssvc_tpu_torch.decode` decodes them, in the same precision and
with the same table.  OffsetDiversity's offset cap is
`LSSVC_OD_OFFSET_CAP` px (10 unless set; 0 or empty: no cap).

`--worker N` runs the tasks on N threads on the one device
(`parallel/scheduler.py`): tasks on one model take its lock in turn, tasks
on different models (several `--model_path` entries) run at once.  The
`--save_*` flags write PNGs under `<path>_<i_frame_model_name>_LSSVC/
<sequence>/<model_idx>/<ratio>/` (`harness/runner.py`), as the JAX CLI
does.  `--intra_rdo` codes each I-frame's BL from latents refined by
latent RDO (`models/rdo.py`): lambda from `--intra_lmbda` (one per
checkpoint; 0.01 without it), `--intra_rdo_iter_to_exit` and
`--intra_rdo_iter_to_reduce`, at most 3000 iterations a frame.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .harness.results import filter_dict
from .harness.runner import ARTIFACTS
from .ops.nn import od_offset_cap_from_env, precision_from_cli
from .parallel.scheduler import Runner
from .utils.platform import resolve_device


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="lssvc_tpu_torch testing script")
    parser.add_argument("--i_frame_model_name", type=str, default="IntraNoAR")
    parser.add_argument("--i_frame_model_path", type=str, nargs="+")
    parser.add_argument("--force_intra", type=str2bool, nargs="?", const=True,
                        default=False)
    parser.add_argument("--force_frame_num", type=int, default=-1)
    parser.add_argument("--force_intra_period", type=int, default=-1)
    parser.add_argument("--intra_rdo", type=str2bool, nargs="?", const=True,
                        default=False)
    parser.add_argument("--intra_lmbda", type=float, nargs="+")
    parser.add_argument("--intra_rdo_iter_to_exit", type=int, default=60)
    parser.add_argument("--intra_rdo_iter_to_reduce", type=int, default=20)
    parser.add_argument("--model_path", type=str, nargs="+")
    parser.add_argument("--inter_mv_rdo", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--inter_feature_rdo", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--inter_lmbda", type=float, nargs="+")
    parser.add_argument("--inter_mv_rdo_iter_to_exit", type=int, default=60)
    parser.add_argument("--inter_mv_rdo_iter_to_reduce", type=int, default=20)
    parser.add_argument("--inter_feature_rdo_iter_to_exit", type=int,
                        default=60)
    parser.add_argument("--inter_feature_rdo_iter_to_reduce", type=int,
                        default=20)
    parser.add_argument("--test_config", type=str, required=True)
    parser.add_argument("--worker", "-w", type=int, default=1)
    parser.add_argument("--cuda", type=str2bool, nargs="?", const=True,
                        default=False, help="accepted for CLI compatibility; "
                        "--device selects the device")
    parser.add_argument("--cuda_device", default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the models (default cuda)")
    parser.add_argument("--write_stream", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--stream_path", type=str, default="out_bin")
    parser.add_argument("--save_decoded_frame", type=str2bool, default=False)
    parser.add_argument("--save_decoded_mv", type=str2bool, default=False)
    parser.add_argument("--save_warp_frame", type=str2bool, default=False)
    parser.add_argument("--save_decoded_context", type=str2bool, default=False)
    parser.add_argument("--decoded_frame_path", type=str,
                        default="decoded_frames")
    parser.add_argument("--decoded_mv_path", type=str, default="decoded_mv")
    parser.add_argument("--warp_frame_path", type=str, default="warp_frame")
    parser.add_argument("--decoded_context_path", type=str,
                        default="decoded_context")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--decoding_profiling", type=str2bool, default=False)
    parser.add_argument("--verbose", type=int, default=0)
    parser.add_argument("--model_name", type=str, default="LSSVC_net")
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "high", "bf16", "int8"],
                        help="fp32 = reference parity, high = TF32 convs "
                             "and matmuls on the GPU, bf16 = bf16 operands "
                             "and outputs (a bf16 stream decodes only in "
                             "bf16), int8 = s8 convs at the calibrated "
                             "packed sites (needs --int8_calib)")
    parser.add_argument("--int8_calib", type=str, default=None,
                        help="activation-scale table JSON from "
                             "lssvc_tpu_torch.tools.int8_calibrate "
                             "(required for --precision int8; the decoder "
                             "must use the same table)")
    parser.add_argument("--ratios", type=str, nargs="+",
                        default=["x2", "x1_5"],
                        help="BL downscale ratios to evaluate")
    return parser.parse_args(argv)


def build_tasks(args, config):
    """One task per (dataset, ratio, sequence, model), as the JAX CLI
    builds them."""
    tasks = []
    for ds_name in config:
        if config[ds_name]["test"] == 0:
            continue
        for ratio in args.ratios:
            for seq_name in config[ds_name]["sequences"]:
                for model_idx in range(len(args.model_path)):
                    seq_cfg = config[ds_name]["sequences"][seq_name]
                    tasks.append({
                        "ratio": ratio,
                        "x1": config[ds_name]["x1"],
                        ratio: config[ds_name].get(ratio),
                        "model_idx": model_idx,
                        "i_frame_model_path": args.i_frame_model_path[model_idx],
                        "i_frame_model_name": args.i_frame_model_name,
                        "video_model_path": args.model_path[model_idx],
                        "video_model_name": args.model_name,
                        "force_intra": args.force_intra,
                        # latent RDO on the I-frames' BL: lmbda from the
                        # per-checkpoint --intra_lmbda list
                        "intra_rdo": args.intra_rdo,
                        "intra_rdo_opt": ({
                            "lmbda": (args.intra_lmbda[model_idx]
                                      if args.intra_lmbda else 0.01),
                            "iter_to_exit": args.intra_rdo_iter_to_exit,
                            "iter_to_reduce": args.intra_rdo_iter_to_reduce,
                        } if args.intra_rdo else None),
                        "video_path": seq_name,
                        "gop": (1 if args.force_intra
                                else (args.force_intra_period
                                      if args.force_intra_period > 0
                                      else seq_cfg["gop"])),
                        "frame_num": (args.force_frame_num
                                      if args.force_frame_num > 0
                                      else seq_cfg["frames"]),
                        "dataset_path": config[ds_name]["base_path"],
                        "write_stream": args.write_stream,
                        "stream_path": args.stream_path,
                        **{f"save_{a}": getattr(args, f"save_{a}")
                           for a in ARTIFACTS},
                        **{f"{a}_path": f"{getattr(args, f'{a}_path')}_"
                                        f"{args.i_frame_model_name}_LSSVC"
                           for a in ARTIFACTS},
                        "ds_name": ds_name,
                        "verbose": args.verbose,
                        "decoding_profiling": args.decoding_profiling,
                        "precision": args.precision,
                    })
    return tasks


def write_results(args, config, results):
    """`{ratio}_{BL,EL,FL}.json` under --output_path: dataset -> sequence
    -> checkpoint basename -> the published keys."""
    os.makedirs(args.output_path, exist_ok=True)
    # checkpoint basenames, told apart by index when a sweep reuses a name
    basenames = [os.path.basename(m) for m in args.model_path]
    ckpt_keys = [b if basenames.count(b) == 1 else f"{i}_{b}"
                 for i, b in enumerate(basenames)]
    for ratio in args.ratios:
        logs = {"BL": {}, "EL": {}, "FL": {}}
        for ds_name in config:
            if config[ds_name]["test"] == 0:
                continue
            for seq in config[ds_name]["sequences"]:
                for layer in logs:
                    logs[layer].setdefault(ds_name, {}).setdefault(seq, {})
                for res_bl, res_el, res_fl in results:
                    # matched on the model index, not the basename
                    if (ds_name == res_bl["ds_name"]
                            and seq == res_bl["video_path"]
                            and res_bl["ratio"] == ratio):
                        ckpt = ckpt_keys[res_bl["model_idx"]]
                        for layer, res in zip(logs, (res_bl, res_el, res_fl)):
                            logs[layer][ds_name][seq][ckpt] = filter_dict(res)
        for layer, log in logs.items():
            with open(os.path.join(args.output_path,
                                   f"{ratio}_{layer}.json"), "w") as fp:
                json.dump(log, fp, indent=2)


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv); returns the tasks' results,
    (log_BL, log_EL, log_FL) per task."""
    begin_time = time.time()
    args = parse_args(argv)
    precision, int8_table = precision_from_cli(args.precision,
                                               args.int8_calib)
    device = resolve_device(args.device)
    if args.force_intra:
        args.model_path = args.i_frame_model_path
    if args.inter_mv_rdo or args.inter_feature_rdo:
        print("note: --inter_mv_rdo/--inter_feature_rdo are accepted for "
              "reference CLI compatibility but not implemented (they are "
              "dead flags in the reference too)")
    if args.cuda or args.cuda_device is not None:
        print("note: --cuda/--cuda_device ignored; --device selects the "
              "device")

    with open(args.test_config) as f:
        config = json.load(f)
    tasks = build_tasks(args, config)
    results = Runner(device, od_offset_cap_from_env(), precision,
                     int8_table).run_tasks(tasks, args.worker)
    write_results(args, config, results)

    count_frames = sum({(t["ds_name"], t["video_path"]): t["frame_num"]
                        for t in tasks}.values())
    count_sequences = len({(t["ds_name"], t["video_path"]) for t in tasks})
    print("Test finished")
    print(f"Tested {len(args.model_path)} models on {count_frames} frames "
          f"from {count_sequences} sequences")
    print(f"Total elapsed time: {(time.time() - begin_time) / 60:.1f} min")
    return results


if __name__ == "__main__":
    main()
