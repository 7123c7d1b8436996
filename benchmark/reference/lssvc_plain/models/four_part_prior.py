"""Four-part quadtree-checkerboard spatial prior (the JAX package's
`models/four_part_prior.py:32-125`).

The EL latent is split into 4 channel quarters x 4 checkerboard spatial
masks and coded in 4 passes; each pass re-estimates (scales, means) for the
not-yet-coded positions from everything decoded so far via a shared
spatial-prior network.  Mask index per (pass, quarter):
    pass 0: (0,1,2,3)   pass 1: (3,2,1,0)   pass 2: (2,3,0,1)   pass 3: (1,0,3,2)
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ste_round
from .components import cat, conv, depth_conv_block

PASS_MASKS = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def checkerboard_masks(h: int, w: int, device, row0: int = 0):
    """Four (1,H,W,1) quad-phase masks: mask k selects (row%2, col%2) phase;
    `row0` is the first row's index in the frame."""
    rows = (row0 + np.arange(h)) % 2
    cols = np.arange(w) % 2
    masks = []
    for (r, c) in ((0, 0), (0, 1), (1, 0), (1, 1)):
        m = ((rows[:, None] == r) & (cols[None, :] == c)).astype(np.float32)
        masks.append(torch.from_numpy(m[None, :, :, None]).to(device))
    return masks


def spatial_prior_net(p, adaptor_scope, x):
    """1x1 adaptor + 3 DepthConvBlocks (`LSSVC_net.py:44-48`)."""
    f = conv(adaptor_scope, x)
    f = depth_conv_block(p.sub("y_spatial_prior.0"), f)
    f = depth_conv_block(p.sub("y_spatial_prior.1"), f)
    return depth_conv_block(p.sub("y_spatial_prior.2"), f)


def _process(y_q_quarter, scales_q, means_q, mask):
    """One (quarter, mask) coding step: returns (y_res, y_q, y_hat, s_hat)."""
    scales_hat = scales_q * mask
    means_hat = means_q * mask
    y_res = (y_q_quarter - means_hat) * mask
    y_q = ste_round(y_res)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


def forward_four_part_prior(p, y, common_params):
    """Forward all 4 passes. Returns (y_res, y_q, y_hat, scales_hat)."""
    _, h, w, _ = y.shape
    masks = checkerboard_masks(h, w, y.device, 0)

    half = common_params.shape[-1] // 2
    scales, means = common_params[..., :half], common_params[..., half:]
    y_4 = torch.chunk(y, 4, dim=-1)
    scales_4 = torch.chunk(scales, 4, dim=-1)
    means_4 = torch.chunk(means, 4, dim=-1)

    # per-quarter accumulators indexed [quarter][mask]
    res_acc = [[None] * 4 for _ in range(4)]
    q_acc = [[None] * 4 for _ in range(4)]
    s_acc = [[None] * 4 for _ in range(4)]

    y_hat_so_far = None
    for pass_idx, mask_ids in enumerate(PASS_MASKS):
        if pass_idx > 0:
            params = cat([y_hat_so_far, common_params])
            pr = spatial_prior_net(
                p, p.sub(f"y_spatial_prior_adaptor_{pass_idx}"), params)
            parts = torch.chunk(pr, 8, dim=-1)
            scales_4 = parts[:4]
            means_4 = parts[4:]

        step_hats = []
        for quarter, mask_id in enumerate(mask_ids):
            y_res, y_q, y_hat, s_hat = _process(
                y_4[quarter], scales_4[quarter], means_4[quarter],
                masks[mask_id])
            res_acc[quarter][mask_id] = y_res
            q_acc[quarter][mask_id] = y_q
            s_acc[quarter][mask_id] = s_hat
            step_hats.append(y_hat)
        step = cat(step_hats)
        y_hat_so_far = step if y_hat_so_far is None else y_hat_so_far + step

    def combine(acc):
        return cat([sum(acc[q][m] for m in range(4)) for q in range(4)])

    return combine(res_acc), combine(q_acc), y_hat_so_far, combine(s_acc)
