"""Device timing and the card's identity, for the port's tools on the GPU."""

from __future__ import annotations

import subprocess

import torch


def time_ms(fn, iters=30, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls, in ms
    (CUDA events around the run, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("this tool measures the GPU: CUDA is not available")
    return torch.device("cuda")
