"""int8 activation calibration of the two-layer video model (the JAX
package's `harness/calibrate.py`).

Produces the {calibration key: activation scale} table that the int8
precision serves from (`ops/int8.py`).  Calibration runs the width-packed
bf16 forward with the model's absmax recorder open (`Model.recording`) over
a few chained synthetic-motion frames; per-tensor scales hardly depend on
the picture size, so a 512x512 run calibrates 1080p serving.

A table is data of the model that serves it (`ops.nn.Mode.int8`), so
serving another table means building another model; there is no cache to
clear.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import LSSVC
from ..ops.int8 import table_from_stats
from ..utils.platform import resolve_device
from ..utils.resize import imresize

# the seed of the random DPB features (the JAX package draws them from
# jax.random.PRNGKey(3), whose bits torch cannot reproduce)
FEATURE_SEED = 3


def synthetic_frames(hw, n_frames, seed=7):
    """Smooth texture + global pan + a moving square (the JAX package's
    recipe, numpy, the same frames)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    small = rng.random((h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    base = np.repeat(np.repeat(small, 16, axis=0), 16, axis=1)[:h, :w]
    sq = h // 8
    out = []
    for t in range(n_frames):
        f = np.roll(base, (int(1.5 * t) % h, int(1.5 * t) % w), axis=(0, 1))
        f = f.copy()
        y0 = (h // 4 + 3 * t) % (h - sq)
        x0 = (w // 4 + 4 * t) % (w - sq)
        f[y0:y0 + sq, x0:x0 + sq] = rng.random(3).astype(np.float32)
        out.append(np.clip(f, 0.0, 1.0))
    return out


def calibrate_video(params, size=512, frames=3, margin=1.0, device="cuda",
                    od_offset_cap=None, seed=FEATURE_SEED):
    """The int8 calibration table of a video model's parameters (a flat
    state dict): a bf16 LSSVC at packed width 2 (the serving mode the
    scales serve) codes `frames` chained frames at EL size x size, BL
    half that (bicubic), from a DPB of random features drawn from a
    torch.Generator seeded with `seed`; each site's input absmax is
    merged by max over the frames."""
    device = resolve_device(device)
    model = LSSVC(params, device=device, od_offset_cap=od_offset_cap,
                  precision="bf16", packed_width=2)
    el_hw, bl_hw = (size, size), (size // 2, size // 2)
    model.set_scale_information(2.0, el_hw, (0, 0, 0, 0))
    xs_el = [torch.from_numpy(f)[None].to(device)
             for f in synthetic_frames(el_hw, frames + 1)]
    xs_bl = [imresize(x.permute(0, 3, 1, 2), sizes=bl_hw)
             .permute(0, 2, 3, 1).contiguous() for x in xs_el]
    gen = torch.Generator().manual_seed(seed)
    dpb = {"ref_frame_bl": xs_bl[0], "ref_frame_el": xs_el[0],
           "ref_feature_bl": torch.rand((1, *bl_hw, 64), generator=gen)
           .to(device),
           "ref_feature_el": torch.rand((1, *el_hw, 48), generator=gen)
           .to(device)}
    agg = {}
    for i in range(frames):
        with model.recording() as stats:
            out = model.forward_one_frame(
                xs_bl[i + 1], xs_el[i + 1], dpb["ref_frame_bl"],
                dpb["ref_frame_el"], dpb["ref_feature_bl"],
                dpb["ref_feature_el"])
        dpb = out["dpb"]
        for k, v in stats.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return table_from_stats(agg, margin=margin)
