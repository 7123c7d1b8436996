"""Latent-domain rate-distortion optimisation of the intra codec (the JAX
package's `models/rdo.py`; reference `priors.py:224-331`, `bits_rdo` /
`global_rdo`).

Gradient refinement of the latents (y, z) against
lambda * 255^2 * MSE + bpp: each iteration moves only the elements whose
gradient magnitude exceeds a fraction (the threshold) of the largest, by
that gradient over the largest times a step, and a staged schedule
raises the thresholds and shrinks the steps after a plateau.

The loss and its gradients come from autograd on the device, with y and z
as fresh leaf tensors and every parameter frozen (`requires_grad=False`,
`models/base.py`): the models' entry points run under `torch.no_grad()`,
so the loss runs under `torch.enable_grad()`.  The plateau bookkeeping
runs on the host and reads the loss once an iteration (`float(loss)`, the
JAX package's one sync).  The update is chaotic: an element near the
threshold moves or not on the last bit of its gradient, so the schedule
and the number of syncs are kept exactly as the JAX package has them.
"""

from __future__ import annotations

import math
import time

import torch

from ..convert import P
from .intra_noar import g_s, hyper_synthesis_quantize

LOG2 = math.log(2.0)
# (threshold_y, step_y, threshold_z, step_z) of the three stages
STAGES = ((0.25, 0.8, 0.25, 0.1), (0.5, 0.2, 0.5, 0.05),
          (0.75, 0.1, 0.75, 0.05))


def _rd_loss(params, y, z, x_padded, lmbda):
    """lmbda * 255^2 * MSE + bpp of the IntraNoAR `params` coding (y, z)
    against `x_padded` (NHWC: the pixels are N * H * W)."""
    y_hat, _, y_lik, z_lik, _, _ = hyper_synthesis_quantize(params, y, z)
    x_hat = g_s(P(params).sub("g_s"), y_hat)
    n, h, w, _ = x_padded.shape
    bpp = (torch.sum(torch.log(z_lik)) + torch.sum(torch.log(y_lik))) / (
        -LOG2 * (n * h * w))
    mse = torch.mean(torch.square(x_hat - x_padded))
    return lmbda * (255.0 ** 2) * mse + bpp


def _loss_and_grads(params, y, z, x_padded, lmbda):
    """(loss, dloss/dy, dloss/dz), all detached."""
    with torch.enable_grad():
        y = y.detach().requires_grad_(True)
        z = z.detach().requires_grad_(True)
        loss = _rd_loss(params, y, z, x_padded, lmbda)
        gy, gz = torch.autograd.grad(loss, (y, z))
    return loss.detach(), gy, gz


def _masked_update(v, grad, threshold, step):
    """v less step * grad / max|grad| where |grad| > threshold *
    max|grad|; v itself when the gradient is all zero.

    v - q * step is rounded once, as the JAX package's update computes it
    (XLA fuses the multiply and the subtract into one FMA): the product of
    two f32 is exact in f64, and the difference is rounded to v's dtype
    from there.  `step` is taken as an f32, as JAX takes a Python float."""
    gmax = torch.max(torch.abs(grad))
    move = (torch.abs(grad) > gmax * threshold) & (gmax > 0)
    q = grad / torch.clamp(gmax, min=1e-30)
    step = float(torch.tensor(step, dtype=torch.float32))
    moved = (v.double() - q.double() * step).to(v.dtype)
    return torch.where(move, moved, v)


def bits_rdo(params, y, z, x_padded, lmbda, max_iter=3000, iter_to_exit=50,
             iter_to_reduce=25, trace=None):
    """Refine (y, z); returns (best_y, best_z, best_loss).  `trace`, a
    list, receives (loss, host seconds) once an iteration, at the loss's
    sync."""
    best_loss = float("inf")
    best_y, best_z = y, z
    stalled = 0
    reduce_counter = 0
    stage = 0

    for _ in range(max_iter):
        loss, gy, gz = _loss_and_grads(params, y, z, x_padded, lmbda)
        loss = float(loss)
        if trace is not None:
            trace.append((loss, time.perf_counter()))
        if loss < best_loss:
            best_loss = loss
            best_y, best_z = y, z
            stalled = 0
            reduce_counter = 0
        else:
            stalled += 1
            reduce_counter += 1

        if stage < 2 and reduce_counter > iter_to_reduce:
            stage += 1
            reduce_counter = 0
            y, z = best_y, best_z
            continue

        ty, sy, tz, sz = STAGES[stage]
        y = _masked_update(y, gy, ty, sy)
        z = _masked_update(z, gz, tz, sz)

        if stalled >= iter_to_exit:
            break
    return best_y, best_z, best_loss


def global_rdo(params, y, z, x_padded, rdo_opt):
    """The reference's `global_rdo` (`priors.py:315-331`): one `bits_rdo`
    run from the analysis latents.  `rdo_opt` keys: lmbda (0.01),
    max_iter (3000), iter_to_exit (60), iter_to_reduce (20) and trace
    (None; see `bits_rdo`)."""
    rdo_opt = rdo_opt or {}
    best_y, best_z, _ = bits_rdo(
        params, y, z, x_padded, rdo_opt.get("lmbda", 0.01),
        max_iter=rdo_opt.get("max_iter", 3000),
        iter_to_exit=rdo_opt.get("iter_to_exit", 60),
        iter_to_reduce=rdo_opt.get("iter_to_reduce", 20),
        trace=rdo_opt.get("trace"))
    return best_y, best_z
