"""Finiteness guards at the symbol-plane boundary and the DPB clamp (the
JAX package's `utils/checks.py`).

A NaN latent cast to int32 encodes garbage into the rANS stream instead of
failing; every stream encoder checks its float planes here before it
writes them.  `finite_flags` reduces on the device without a host sync;
`raise_if_nonfinite` reads the flags on the host in one copy, which the
stream encoders do only after the frame's device work is queued.
"""

from __future__ import annotations

import numpy as np
import torch

# the DPB clamp's bounds: frames at +-8, features at +-65536
FRAME_BOUND = 8.0
FEATURE_BOUND = 65536.0


def finite_flags(**tensors) -> dict:
    """name -> 0-dim bool tensor on the tensor's device (no host sync)."""
    return {k: torch.isfinite(v).all() for k, v in tensors.items()}


def raise_if_nonfinite(what: str, flags: dict) -> None:
    """Host half: one copy of the flags, then a FloatingPointError naming
    the planes that hold NaN or Inf."""
    ok = torch.stack(list(flags.values())).cpu().tolist()
    bad = sorted(k for k, good in zip(flags, ok) if not good)
    if bad:
        raise FloatingPointError(
            f"{what}: non-finite values in {bad}; refusing to emit a "
            "corrupt bitstream")


def assert_finite(what: str, **tensors) -> None:
    """`finite_flags` then `raise_if_nonfinite`: waits for the tensors."""
    raise_if_nonfinite(what, finite_flags(**tensors))


def assert_finite_np(what: str, **arrays) -> None:
    """Host-side check of numpy planes at the coder boundary."""
    bad = sorted(k for k, a in arrays.items()
                 if not np.all(np.isfinite(np.asarray(a))))
    if bad:
        raise FloatingPointError(
            f"{what}: non-finite values in {bad}; refusing to emit a "
            "corrupt bitstream")


def sanitize_dpb(dpb: dict) -> dict:
    """Bound the decoded-picture buffer at the stream entry points.

    A model run past its trained chain length can drift its feedback
    features until a P-frame's prior nets emit non-finite planes; clamping
    the recurrence at each frame boundary turns that encode abort into a
    loss of quality until the next I-frame.  The encoder's feedback DPB is
    the decoder's output, so the same clamp at `compress` and `decompress`
    keeps the two in step.  A healthy DPB passes bit for bit: frames are
    bounded at +-8 (the recon of a random init lives in about +-3),
    features at +-65536 (random-init textures reach +-3.6e3; the blow-ups
    are 1e9 and more).  NaN becomes 0 and +-Inf the bound.  Entries that
    are not tensors (a None feature) pass as they are."""
    out = {}
    for k, v in dpb.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        bound = FRAME_BOUND if k.startswith("ref_frame") else FEATURE_BOUND
        out[k] = torch.clamp(torch.nan_to_num(v, nan=0.0, posinf=bound,
                                              neginf=-bound), -bound, bound)
    return out
