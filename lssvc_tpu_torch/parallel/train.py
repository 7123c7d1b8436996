"""RD training of the two-layer codec (the JAX package's
`parallel/train.py`): one device, or data-parallel over the ranks of a
process group (`make_sharded_train_step`, `make_sharded_train_scan`).

A train step differentiates the module-level model functions
(`models/lssvc.py` `forward_one_frame`, `models/intra_ss.py` `forward`,
`models/components.py` `me_spynet`) with respect to the flat parameter dict,
whose tensors it takes as leaves; on the GPU the warps' gradients are the
hand-written backward kernels (`ops/warp_kernels.py`).  Quantisation is the
straight-through rounding of `ops.ste_round`, so one forward serves
evaluation and training; the objective is the reference's loss shape
(lambda * 255^2 * MSE + bpp, `rd_loss_intra.py:6-37`) over both layers.

The optimizer is `Adam`, written to optax's arithmetic (`optax.adam`,
`optax.cosine_decay_schedule`, and `optax.multi_transform` with
`set_to_zero` for a frozen partition) so that the port and the JAX package
take the same step from the same gradients.  Parameters and optimizer
state stay f32 whatever the compute precision.

Data parallelism: every rank holds the parameters and optimizer state,
takes the loss and gradient of its rows of the global batch, and the
ranks average the gradients with one all-reduce of a flat buffer.  Every
loss here is a mean over the batch's items (`_bpp` divides the summed
bits by the batch's pixels, `_mse` is a mean, the cascade averages its
frames, the intra aux loss reads no item), so the average of the ranks'
gradients is the global batch's gradient, which the JAX package's GSPMD
step computes.  The same Adam then runs on every rank on the same
numbers, so parameters and optimizer state stay bit-equal across ranks
(`replicas_equal` checks it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import P
from ..entropy.models import entropy_bottleneck_aux_loss
from ..models import intra_ss as intra_ss_model
from ..models import lssvc as lssvc_model
from ..models.components import me_spynet
from ..ops.nn import Mode, clip, precision_scope
from ..ops.warp_kernels import flow_warp
from ..utils import collectives
from .mesh import group_or_world, shard_batch, world_of

BL_PREFIX = "base_layer_model."


def _bpp(out, x_bl, x_el):
    n_el = x_el.shape[0] * x_el.shape[1] * x_el.shape[2]
    n_bl = x_bl.shape[0] * x_bl.shape[1] * x_bl.shape[2]
    return out["bit_el"] / n_el + out["bit_bl"] / n_bl


def _mse(a, b):
    return torch.mean(torch.square(a.float() - b))


def _pair_forward(params, batch, shape_hr, scale_factor, pad_size):
    return lssvc_model.forward_one_frame(
        params, batch["x_bl"], batch["x_el"], batch["ref_bl"],
        batch["ref_el"], None, None, shape_hr, scale_factor, pad_size)


def rd_loss(params, batch, lmbda, shape_hr, scale_factor, pad_size):
    """Two-frame conditional coding: frame t against frame t-1.

    batch: x_bl, x_el, ref_bl, ref_el, all NHWC."""
    out = _pair_forward(params, batch, shape_hr, scale_factor, pad_size)
    mse_el = _mse(out["dpb"]["ref_frame_el"], batch["x_el"])
    mse_bl = _mse(out["dpb"]["ref_frame_bl"], batch["x_bl"])
    bpp = _bpp(out, batch["x_bl"], batch["x_el"])
    loss = lmbda * (255.0 ** 2) * (mse_el + mse_bl) + bpp
    return loss, {"loss": loss, "bpp": bpp, "mse_el": mse_el,
                  "mse_bl": mse_bl}


def rd_loss_warp(params, batch, lmbda, shape_hr, scale_factor, pad_size):
    """The motion stage's loss: distortion on the motion-compensated warped
    predictions instead of the recon (the recon path is frozen at init in
    that stage, and its MSE would bury the motion gradient), plus the
    total bpp."""
    out = _pair_forward(params, batch, shape_hr, scale_factor, pad_size)
    mse_el = _mse(out["warp_frame"], batch["x_el"])
    mse_bl = _mse(out["warp_frame_bl"], batch["x_bl"])
    bpp = _bpp(out, batch["x_bl"], batch["x_el"])
    loss = lmbda * (255.0 ** 2) * (mse_el + mse_bl) + bpp
    return loss, {"loss": loss, "bpp": bpp, "mse_el": mse_el,
                  "mse_bl": mse_bl}


def spynet_loss(params, batch, lmbda, shape_hr, scale_factor, pad_size):
    """SpyNet pretraining, self-supervised: mse(warp(ref, spynet(x, ref)),
    x) in both layers plus a small total-variation prior on the flows.
    lmbda is unused (no rate term)."""
    del lmbda, shape_hr, scale_factor, pad_size
    p = P(params)
    flow_el = me_spynet(p.sub("optic_flow"), batch["x_el"], batch["ref_el"])
    warp_el = flow_warp(batch["ref_el"], flow_el)
    bl = p.sub("base_layer_model")
    flow_bl = me_spynet(bl.sub("optic_flow"), batch["x_bl"], batch["ref_bl"])
    warp_bl = flow_warp(batch["ref_bl"], flow_bl)
    mse_el = _mse(warp_el, batch["x_el"])
    mse_bl = _mse(warp_bl, batch["x_bl"])

    def tv(f):
        return (torch.mean(torch.abs(torch.diff(f, dim=1)))
                + torch.mean(torch.abs(torch.diff(f, dim=2))))

    loss = mse_el + mse_bl + 1e-4 * (tv(flow_el) + tv(flow_bl))
    return loss, {"loss": loss, "bpp": loss.new_zeros(()), "mse_el": mse_el,
                  "mse_bl": mse_bl}


def rd_loss_cascade(params, batch, lmbda, shape_hr, scale_factor, pad_size,
                    warm: int = 0):
    """Multi-frame RD over a short decoded-picture-buffer chain.

    batch: x_bl, x_el of shape (B, T, H, W, 3).  Frame 0 is the
    uncompressed reference; frames 1..T-1 are coded in turn, each against
    the previous frame's reconstruction, so the gradient sees the error the
    chain accumulates.  The first `warm` steps run without autograd and add
    no loss: they build a DPB with features, so the steps with a loss train
    the steady-state P-frame (the JAX package's stop_gradient).  Only the
    fed-back frames are clamped to [0, 1], as the eval harness clamps."""
    x_bl, x_el = batch["x_bl"], batch["x_el"]
    t = x_el.shape[1]
    dpb = {"ref_frame_bl": x_bl[:, 0], "ref_frame_el": x_el[:, 0],
           "ref_feature_bl": None, "ref_feature_el": None}
    total = bpp_acc = mse_el_acc = mse_bl_acc = 0.0
    for i in range(1, t):
        with torch.set_grad_enabled(torch.is_grad_enabled() and i > warm):
            out = lssvc_model.forward_one_frame(
                params, x_bl[:, i], x_el[:, i], dpb["ref_frame_bl"],
                dpb["ref_frame_el"], dpb["ref_feature_bl"],
                dpb["ref_feature_el"], shape_hr, scale_factor, pad_size)
        dpb = dict(out["dpb"])
        dpb["ref_frame_bl"] = clip(dpb["ref_frame_bl"], 0.0, 1.0)
        dpb["ref_frame_el"] = clip(dpb["ref_frame_el"], 0.0, 1.0)
        if i <= warm:
            continue
        # distortion on the raw recon: a clamp before the MSE would zero the
        # gradient of every pixel out of range
        mse_el = _mse(out["dpb"]["ref_frame_el"], x_el[:, i])
        mse_bl = _mse(out["dpb"]["ref_frame_bl"], x_bl[:, i])
        bpp = _bpp(out, x_bl[:, i], x_el[:, i])
        total = total + lmbda * (255.0 ** 2) * (mse_el + mse_bl) + bpp
        bpp_acc = bpp_acc + bpp
        mse_el_acc = mse_el_acc + mse_el
        mse_bl_acc = mse_bl_acc + mse_bl
    n = t - 1 - warm
    loss = total / n
    return loss, {"loss": loss, "bpp": bpp_acc / n, "mse_el": mse_el_acc / n,
                  "mse_bl": mse_bl_acc / n}


def rd_loss_intra(params, batch, lmbda, shape_hr, pad_size=(0, 0, 0, 0),
                  aux_weight: float = 1.0):
    """IntraSS two-layer RD plus the EntropyBottlenecks' quantile aux loss
    (one objective: the aux loss touches only the quantiles, which the RD
    term does not read).  batch: x_bl, x_el NHWC."""
    el = {k: v for k, v in params.items() if not k.startswith(BL_PREFIX)}
    bl = {k[len(BL_PREFIX):]: v for k, v in params.items()
          if k.startswith(BL_PREFIX)}
    x_el, x_bl = batch["x_el"], batch["x_bl"]
    out = intra_ss_model.forward(el, bl, x_bl, x_el, shape_hr, pad_size)
    mse_el = _mse(out["x_hat_el"], x_el)
    mse_bl = _mse(out["x_hat_bl"], x_bl)
    bpp = _bpp(out, x_bl, x_el)
    rd = lmbda * (255.0 ** 2) * (mse_el + mse_bl) + bpp
    p = P(params)
    aux = (entropy_bottleneck_aux_loss(p.sub("entropy_bottleneck"))
           + entropy_bottleneck_aux_loss(
               p.sub("base_layer_model.entropy_bottleneck")))
    loss = rd + aux_weight * aux
    return loss, {"loss": rd, "bpp": bpp, "mse_el": mse_el, "mse_bl": mse_bl,
                  "aux": aux}


_LOSSES = {"pair": rd_loss, "warp": rd_loss_warp, "spynet": spynet_loss,
           "cascade": rd_loss_cascade}
LOSSES = (*_LOSSES, "intra")


def make_loss_fn(lmbda: float, shape_hr, scale_factor=2.0,
                 pad_size=(0, 0, 0, 0), loss: str = "pair",
                 cascade_warm: int = 0):
    """loss_fn(params, batch) -> (loss, metrics); lambda is read from
    `batch["lmbda"]` when the batch has one."""
    if loss not in LOSSES:
        raise ValueError(f"loss {loss!r}, expected one of {LOSSES}")

    def loss_fn(params, batch):
        lm = batch.get("lmbda", lmbda)
        if loss == "intra":
            return rd_loss_intra(params, batch, lm, shape_hr, pad_size)
        if loss == "cascade":
            return rd_loss_cascade(params, batch, lm, shape_hr, scale_factor,
                                   pad_size, warm=cascade_warm)
        return _LOSSES[loss](params, batch, lm, shape_hr, scale_factor,
                             pad_size)

    return loss_fn


def value_and_grad(loss_fn, params: dict, batch: dict, keys=None):
    """(loss, metrics, grads): the gradient of `loss_fn(params, batch)` with
    respect to the parameters named in `keys` (all by default), each taken
    as a leaf; a parameter the loss does not reach gets zeros (as
    `jax.grad`).  Metrics are detached."""
    keys = list(params) if keys is None else list(keys)
    wanted = set(keys)
    leaves = {k: v.detach().requires_grad_(k in wanted)
              for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        got = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                  allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(keys, got)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


# ---------------------------------------------------------------------------
# The optimizer: optax's arithmetic in f32

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """`optax.cosine_decay_schedule`: count -> the rate, an f32 value,
    init * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count, T) / T)) + alpha),
    every operation in f32 as optax computes it.  The cosine is rounded
    to f32 from a float64 cosine of the f32 argument; XLA's f32 cosine is an
    approximation of its own, so a rate may differ from optax's by one f32
    ulp (`tests/test_torch_train.py`)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = min(f32(count), f32(decay_steps))
        arg = f32(math.pi) * c / f32(decay_steps)
        cd = f32(0.5) * (f32(1) + f32(math.cos(float(arg))))
        return float(f32(init_value) * (f32(1 - alpha) * cd + f32(alpha)))

    return schedule


class Adam:
    """`optax.adam(learning_rate)` (b1 0.9, b2 0.999, eps 1e-8), optionally
    under the reference's selective freeze: `labels` (key -> label) and
    `frozen` (a label) give `optax.multi_transform` of `set_to_zero` for the
    frozen label and Adam for the rest, whose state then holds only the
    trained keys.

    `learning_rate` is a float or a schedule (count -> float, counted from 0
    at the first update).  The state is a dict: `count` (updates so far),
    `mu` and `nu` (key -> f32 tensor).  The arithmetic is optax's, one
    rounding per operation: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t) with b^t an f32
    power, update = -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, train.py's

    def __init__(self, learning_rate, labels: dict | None = None,
                 frozen: str | None = None):
        self.learning_rate = learning_rate
        self.labels = labels
        self.frozen = frozen

    def trained(self, params) -> list[str]:
        """The keys that take updates."""
        if self.frozen is None:
            return list(params)
        return [k for k in params if self.labels[k] != self.frozen]

    def init(self, params: dict) -> dict:
        keys = self.trained(params)
        return {"count": 0,
                "mu": {k: torch.zeros_like(params[k]) for k in keys},
                "nu": {k: torch.zeros_like(params[k]) for k in keys}}

    def _rate(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def update(self, grads: dict, state: dict, params: dict | None = None):
        """(updates, new state): updates for the trained keys (a frozen key
        takes none)."""
        keys = list(state["mu"])
        count = state["count"] + 1
        if not keys:  # everything frozen
            return {}, dict(state, count=count)
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(
                                    [state["mu"][k] for k in keys], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul([state["nu"][k] for k in keys], self.b2))
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        # a true division: torch divides by a scalar as a product with its
        # reciprocal, which can round otherwise than optax's division
        mu_hat = torch._foreach_div(mu, [torch.full_like(t, bc1) for t in mu])
        nu_hat = torch._foreach_div(nu, [torch.full_like(t, bc2) for t in nu])
        # the f32 square root correctly rounded, as optax's: taken in f64
        # (torch's f32 sqrt on the CPU can be an ulp off)
        den = torch._foreach_add(
            [torch.sqrt(t.double()).float() for t in nu_hat], self.eps)
        step = float(-f32(self._rate(state["count"])))
        upd = torch._foreach_mul(torch._foreach_div(mu_hat, den), step)
        return (dict(zip(keys, upd)),
                {"count": count, "mu": dict(zip(keys, mu)),
                 "nu": dict(zip(keys, nu))})


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates for the updated keys; the others as they are."""
    keys = list(updates)
    new = torch._foreach_add([params[k] for k in keys],
                             [updates[k] for k in keys])
    return {**params, **dict(zip(keys, new))}


def make_optimizer(learning_rate=1e-4, labels=None, frozen=None) -> Adam:
    return Adam(learning_rate, labels=labels, frozen=frozen)


def make_train_step(optimizer: Adam, lmbda: float, shape_hr,
                    scale_factor=2.0, pad_size=(0, 0, 0, 0),
                    loss: str = "pair", cascade_warm: int = 0,
                    precision: str = "fp32"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  loss: "pair" (one P-frame), "warp", "spynet", "cascade" (a
    DPB chain with `cascade_warm` forward-only steps) or "intra" (IntraSS
    and the aux loss).  The forward and backward run inside
    `precision_scope` of `precision` ("fp32", "high" or "bf16"); the
    parameters and the optimizer state stay f32.  Only the optimizer's
    trained keys are differentiated."""
    if precision not in ("fp32", "high", "bf16"):
        raise ValueError(f"precision {precision!r}: expected fp32, high or "
                         "bf16")
    loss_fn = make_loss_fn(lmbda, shape_hr, scale_factor, pad_size, loss,
                           cascade_warm)
    mode = Mode(precision)

    def train_step(params, opt_state, batch):
        with precision_scope(mode):
            _, metrics, grads = value_and_grad(loss_fn, params, batch,
                                               optimizer.trained(params))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Data parallelism over a process group

def _average(tensors: list, group, world: int) -> list:
    """The ranks' mean of each tensor: one all-reduce of a flat f32 buffer
    (float64 where a tensor is; not one collective a key); the tensors as
    they are without a process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return list(tensors)
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    flat = torch.div(collectives.all_reduce(flat, group), world)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def data_parallel_grads(loss_fn, params: dict, batch: dict, keys, group):
    """(metrics, grads) of the global `batch` over the ranks of `group`:
    this rank differentiates its rows (`mesh.shard_batch`), then the
    gradients and the metrics are averaged over the ranks by one
    all-reduce of a flat buffer.  Every rank passes the same batch."""
    _, world = world_of(group)
    _, metrics, grads = value_and_grad(loss_fn, params,
                                       shard_batch(batch, group), keys)
    keys = list(grads)
    names = sorted(metrics)
    avg = _average([grads[k] for k in keys]
                   + [metrics[k].reshape(()) for k in names], group, world)
    return (dict(zip(names, avg[len(keys):])),
            dict(zip(keys, avg[:len(keys)])))


def make_data_parallel_step(loss_fn, optimizer: Adam, group=None,
                            mode: Mode | None = None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics) of
    any loss_fn(params, batch) -> (loss, metrics), data-parallel over
    `group` (`data_parallel_grads`), the same `optimizer` update on every
    rank; the forward and backward in `mode` (fp32 by default)."""
    mode = mode or Mode()

    def train_step(params, opt_state, batch):
        with precision_scope(mode):
            metrics, grads = data_parallel_grads(
                loss_fn, params, batch, optimizer.trained(params), group)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, metrics

    return train_step


def make_sharded_train_step(group, optimizer: Adam, lmbda: float, shape_hr,
                            scale_factor=2.0, pad_size=(0, 0, 0, 0),
                            loss: str = "pair", cascade_warm: int = 0,
                            precision: str = "fp32"):
    """Data-parallel `make_train_step` over `group` (the default group when
    None): step(params, opt_state, batch) -> (params, opt_state, metrics)
    with `batch` the GLOBAL batch, every rank passing the same one.  Each
    rank differentiates its rows (`mesh.shard_batch`: rows [r*b, (r+1)*b)),
    the gradients and the metrics are averaged over the ranks by one
    all-reduce, and the same Adam runs on every rank."""
    if precision not in ("fp32", "high", "bf16"):
        raise ValueError(f"precision {precision!r}: expected fp32, high or "
                         "bf16")
    loss_fn = make_loss_fn(lmbda, shape_hr, scale_factor, pad_size, loss,
                           cascade_warm)
    return make_data_parallel_step(loss_fn, optimizer, group,
                                   Mode(precision))


def scan(step):
    """K chained steps of `step` (the JAX package's `lax.scan` over a (K, B,
    ...) stack of batches): scan_fn(params, opt_state, batches, lmbda) ->
    (params, opt_state, metrics), `batches` values (K, B, ...), step i on
    batches[i], the metrics stacked (K,)."""
    def scan_fn(params, opt_state, batches, lmbda_s=None):
        ms = []
        for i in range(next(iter(batches.values())).shape[0]):
            b = {key: v[i] for key, v in batches.items()}
            if lmbda_s is not None:
                b["lmbda"] = lmbda_s
            params, opt_state, m = step(params, opt_state, b)
            ms.append(m)
        return params, opt_state, {key: torch.stack([m[key] for m in ms])
                                   for key in ms[0]}

    return scan_fn


def make_sharded_train_scan(group, optimizer: Adam, lmbda: float, shape_hr,
                            scale_factor=2.0, pad_size=(0, 0, 0, 0),
                            loss: str = "pair", cascade_warm: int = 0,
                            precision: str = "fp32"):
    """`scan` of `make_sharded_train_step`: each step's batch is the global
    batch (K, B_global, ...)[i], each rank differentiating its rows of
    it."""
    return scan(make_sharded_train_step(group, optimizer, lmbda, shape_hr,
                                        scale_factor, pad_size, loss,
                                        cascade_warm, precision))


def replicas_equal(tensors: list, group=None) -> bool:
    """Whether every rank holds the same bits in `tensors`: a SHA-256 of
    each rank's bytes, gathered and compared with rank 0's."""
    _, world = world_of(group)
    if world == 1:
        return True
    import hashlib

    import torch.distributed as dist

    group = group_or_world(group)
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                      .cpu().numpy().tobytes())
    mine = torch.frombuffer(bytearray(digest.digest()), dtype=torch.uint8)
    if dist.get_backend(group) == "nccl":
        mine = mine.cuda()
    parts = collectives.all_gather(mine, group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def train_state_tensors(params: dict, opt_state: dict) -> list:
    """The tensors of a train state in a fixed order (for
    `replicas_equal`)."""
    return ([params[k] for k in sorted(params)]
            + [opt_state["mu"][k] for k in sorted(opt_state["mu"])]
            + [opt_state["nu"][k] for k in sorted(opt_state["nu"])])
