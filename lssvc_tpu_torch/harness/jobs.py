"""Sweep and job orchestration (the JAX package's `harness/jobs.py`; the
reference's cluster scaffolding, `src/utils/job_submitter.py` and
`submit_test.py`).

A sweep is a `JobConfig` (the checkpoints of the 4 rate points, the test
config, output directories), loaded from JSON, whose command is the
port's CLI, `python3 -m lssvc_tpu_torch.test ...`.  Commands run locally,
one after another or on a thread pool, or are printed for an outside
launcher (`dry_run`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from multiprocessing.pool import ThreadPool


@dataclasses.dataclass
class JobConfig:
    """Locations of everything a sweep needs (4 rate points q1..q4)."""

    image_models: list          # IntraSS checkpoints
    video_models: list          # LSSVC checkpoints
    test_config: str = "recommend_test_config.json"
    output_root: str = "output"
    stream_path: str = "out_bin"
    experiment_name: str = "LSSVC_IP32"
    write_stream: bool = False
    worker: int = 1
    extra_flags: str = ""

    @classmethod
    def from_json(cls, path: str) -> "JobConfig":
        with open(path) as f:
            return cls(**json.load(f))


def build_test_command(cfg: JobConfig, force_intra_period: int = -1) -> str:
    """The evaluation command of one experiment."""
    parts = [
        "python3 -m lssvc_tpu_torch.test",
        "--i_frame_model_name IntraSS",
        "--i_frame_model_path " + " ".join(cfg.image_models),
        "--model_path " + " ".join(cfg.video_models),
        f"--test_config {cfg.test_config}",
        f"--worker {cfg.worker}",
        f"--write_stream {int(cfg.write_stream)}",
        f"--output_path {os.path.join(cfg.output_root, cfg.experiment_name)}",
        f"--stream_path {cfg.stream_path}",
    ]
    if force_intra_period > 0:
        parts.append(f"--force_intra_period {force_intra_period}")
    if cfg.extra_flags:
        parts.append(cfg.extra_flags)
    return " ".join(parts)


def build_intra_command(cfg: JobConfig) -> str:
    """Intra-only sweep (gop 1)."""
    return build_test_command(cfg) + " --force_intra 1"


def run_commands(commands, workers: int = 1, dry_run: bool = False):
    """Run shell commands, on `workers` threads when more than one; with
    `dry_run`, print them instead.  Returns their exit codes."""
    if dry_run:
        for c in commands:
            print(c)
        return [0] * len(commands)

    def _run(cmd):
        print(f"[jobs] {cmd}")
        return subprocess.call(cmd, shell=True)

    if workers <= 1:
        return [_run(c) for c in commands]
    with ThreadPool(workers) as pool:
        return pool.map(_run, commands)
