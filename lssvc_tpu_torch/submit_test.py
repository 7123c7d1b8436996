"""Canned evaluation submission (the twin of the root `submit_test.py`):
builds and runs the 4-rate-point sweep command of a JSON job config
(`harness/jobs.py` `JobConfig`) through the port's CLI.

    python -m lssvc_tpu_torch.submit_test --job-config my_job.json \\
        [--intra-period 32] [--dry-run]
"""

from __future__ import annotations

import argparse

from .harness.jobs import JobConfig, build_test_command, run_commands


def main(argv=None):
    """Returns the command's exit code (0 with `--dry-run`)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--job-config", type=str, required=True)
    parser.add_argument("--intra-period", type=int, default=-1)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    cfg = JobConfig.from_json(args.job_config)
    command = build_test_command(cfg, force_intra_period=args.intra_period)
    return run_commands([command], dry_run=args.dry_run)[0]


if __name__ == "__main__":
    raise SystemExit(main())
