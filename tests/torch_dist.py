"""Ranks of a `gloo` process group for the port's parallel tests.

`run(fn, world, tmp_path, *args)` starts `world` processes with
torch.multiprocessing's `spawn` (fresh interpreters: no JAX and no state
of the test process), joins them into one gloo group over a FileStore
under `tmp_path` (no TCP port to collide between pytest-xdist workers),
calls `fn(rank, world, *args)` in each and returns each rank's result,
passed back through torch.save.  Each rank takes its share of the test
worker's cores (`torch_threads.share_cores`).  The rank functions are
module-level, here, so that the children can import them.
"""

from __future__ import annotations

import datetime
import os
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DPB_KEYS = ("ref_frame_bl", "ref_frame_el", "ref_feature_bl",
            "ref_feature_el")


def _threads(world: int) -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(workers, 1) // world)


def _entry(rank, fn, world, store, out, args, threads):
    torch.set_num_threads(threads)
    if store is None:  # a process of its own, in no group
        torch.save(fn(rank, world, *args), f"{out}{rank}.pt")
        return
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        torch.save(fn(rank, world, *args), f"{out}{rank}.pt")
    finally:
        dist.destroy_process_group()


def run(fn, world, tmp_path, *args, group=True, threads_of=None):
    """[fn(r, world, *args) for r in range(world)], each on its own rank;
    with group=False, `world` processes in no process group (a
    one-process reference with the threads of a rank of `threads_of`
    ranks)."""
    tag = uuid.uuid4().hex
    store = os.path.join(str(tmp_path), f"store-{tag}") if group else None
    out = os.path.join(str(tmp_path), f"result-{tag}-")
    threads = _threads(threads_of or world)
    mp.spawn(_entry, args=(fn, world, store, out, args, threads),
             nprocs=world, join=True)
    return [torch.load(f"{out}{r}.pt", weights_only=False)
            for r in range(world)]


def strip(x, rank, world):
    """Rank `rank`'s rows of a whole NHWC array or tensor."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    h = x.shape[1] // world
    return x[:, rank * h:(rank + 1) * h].contiguous()


# ---------------------------------------------------------------------------
# rank functions


def jobs(rank, world, todo):
    """Several rank functions of this module in one start of the ranks:
    todo = [(name, args)], their results in order."""
    return [globals()[name](rank, world, *args) for name, args in todo]


def warp_cases(rank, world, cases):
    """Halo warps on this rank's strips, each case (name, kwargs, arrays):
    this rank's output rows and the branch counts of each, or the
    ValueError it raised."""
    from lssvc_tpu_torch.parallel import spatial

    results = []
    for name, kwargs, arrays in cases:
        ins = [strip(a, rank, world) for a in arrays]
        spatial.reset_counts()
        try:
            out = getattr(spatial, name)(*ins, **kwargs)
        except ValueError as err:
            results.append({"error": str(err)})
            continue
        results.append({"out": out, "counts": spatial.branch_counts()})
    return results


def spatial_frames(rank, world, params, frames, el_hw, scale, kernel_warps,
                   halo, halo_grouped):
    """`make_spatial_forward` on this rank's strips, chained over `frames`
    (each (x_bl, x_el)) from `frames[0]`'s DPB: each frame's gathered DPB
    and bits, and the warp branch counts."""
    from lssvc_tpu_torch.ops import warp_kernels as wk
    from lssvc_tpu_torch.parallel import spatial

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    group = dist.group.WORLD
    fwd = spatial.make_spatial_forward(group, el_hw, scale, (0, 0, 0, 0),
                                       kernel_warps=kernel_warps, halo=halo,
                                       halo_grouped=halo_grouped)
    sh = spatial.h_sharding(group)
    dpb = {k: strip(v, rank, world) for k, v in frames[0][2].items()}
    outs = []
    spatial.reset_counts()
    wk.flow_warp.launches = wk.grouped_warp.launches = 0
    for x_bl, x_el, _ in frames:
        dpb, bits = fwd(params, strip(x_bl, rank, world),
                        strip(x_el, rank, world), dpb)
        outs.append({"dpb": {k: sh.gather(v) for k, v in dpb.items()},
                     "bits": float(bits)})
    return {"frames": outs, "counts": spatial.branch_counts(),
            "plan": spatial.level_plan([el_hw[0] >> i for i in range(7)]
                                       + [int(el_hw[0] / scale) >> i
                                          for i in range(7)])}


def spatial_intra(rank, world, params, bl_params, x_bl, x_el, el_hw):
    """`make_spatial_intra_forward` on this rank's strips: the gathered
    x_hat_el and the bits."""
    from lssvc_tpu_torch.parallel import spatial

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    bl_params = {k: torch.as_tensor(v) for k, v in bl_params.items()}
    group = dist.group.WORLD
    fwd = spatial.make_spatial_intra_forward(group, el_hw)
    x_hat, bits = fwd(params, bl_params, strip(x_bl, rank, world),
                      strip(x_el, rank, world))
    return {"x_hat_el": spatial.h_sharding(group).gather(x_hat),
            "bits": float(bits)}


def toy_loss(params, batch):
    """The JAX package's toy data-parallel loss (`tests/test_parallel.py:
    28-30`): mean((x @ w + b - y)^2)."""
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean(torch.square(pred - batch["y"]))
    return loss, {"loss": loss}


def toy_steps(rank, world, params, batch, lr, steps):
    """`steps` data-parallel Adam steps of `toy_loss` on the global batch,
    from rank 0's parameters (`mesh.replicate`): the parameters and the
    last metrics."""
    from lssvc_tpu_torch.parallel.train import Adam, make_data_parallel_step

    from lssvc_tpu_torch.parallel.mesh import replicate

    # every rank but 0 starts elsewhere; `replicate` gives it rank 0's
    params = {k: torch.as_tensor(v) + rank for k, v in params.items()}
    replicate(params)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    opt = Adam(lr)
    state = opt.init(params)
    step = make_data_parallel_step(toy_loss, opt)
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
    return params, metrics


def dp_grads(rank, world, params, batch, loss):
    """The data-parallel gradient of the global batch in float64 (`loss` at
    the batch's crop; rank 0 returns it), the rows this rank took, and
    whether Adam's update from it (the step's second half, in f32) leaves
    the parameters and moments bit-equal across the ranks."""
    from lssvc_tpu_torch.parallel import mesh
    from lssvc_tpu_torch.parallel.train import (Adam, apply_updates,
                                                data_parallel_grads,
                                                make_loss_fn, replicas_equal,
                                                train_state_tensors)

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    batch = {k: torch.as_tensor(v).double() for k, v in batch.items()}
    rows = mesh.shard_batch(batch)
    crop = batch["x_el"].shape[-2]
    loss_fn = make_loss_fn(0.01, (crop, crop), loss=loss)
    metrics, grads = data_parallel_grads(
        loss_fn, {k: v.double() for k, v in params.items()}, batch,
        list(params), None)
    opt = Adam(1e-4)
    updates, state = opt.update({k: g.float() for k, g in grads.items()},
                                opt.init(params), params)
    new = apply_updates(params, updates)
    return {"rows": rows["x_el"].shape[0],
            "first_row": rows["x_el"][:, 0, 0, 0].float(),
            "grads": grads if rank == 0 else None, "metrics": metrics,
            "equal": replicas_equal(train_state_tensors(new, state))}


def serve(rank, world, params, frames_bl, frames_el, dpb0, el_hw):
    """`serve_streams` on this rank's stream: its final DPB and the (T, B,
    2) bits."""
    from lssvc_tpu_torch.parallel.serve import serve_streams

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    dpb0 = {k: torch.as_tensor(v) for k, v in dpb0.items()}
    dpb, bits = serve_streams(params, torch.as_tensor(frames_bl),
                              torch.as_tensor(frames_el), dpb0,
                              shape_hr=el_hw)
    return {"dpb": dpb, "bits": bits}


def cli(rank, world, argv):
    """`python -m lssvc_tpu_torch.train argv` as torchrun would start it on
    this rank (its environment; the process group is this module's)."""
    from lssvc_tpu_torch import train

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    train.main(argv)
    return None


def global_grads(rank, world, params, batch, el_hw):
    """The one-process float64 gradient of the `pair` loss on the whole
    batch (the reference of `dp_grads`)."""
    from lssvc_tpu_torch.parallel.train import make_loss_fn, value_and_grad

    params = {k: torch.as_tensor(v).double() for k, v in params.items()}
    batch = {k: torch.as_tensor(v).double() for k, v in batch.items()}
    loss_fn = make_loss_fn(0.01, el_hw, loss="pair")
    _, metrics, grads = value_and_grad(loss_fn, params, batch)
    return metrics, grads


def streams_alone(rank, world, params, frames_bl, frames_el, dpb0, el_hw):
    """Each stream of `serve` run alone, in one process."""
    from lssvc_tpu_torch.parallel.serve import make_serving_step

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    step = make_serving_step(None, shape_hr=el_hw)
    out = []
    for b in range(frames_bl.shape[1]):
        dpb = {k: torch.as_tensor(v[b:b + 1]) for k, v in dpb0.items()}
        bits = []
        for t in range(frames_bl.shape[0]):
            dpb, bb = step(params, torch.as_tensor(frames_bl[t, b:b + 1]),
                           torch.as_tensor(frames_el[t, b:b + 1]), dpb)
            bits.append(bb[0])
        out.append({"dpb": dpb, "bits": torch.stack(bits)})
    return out


def plain_cli(rank, world, argv):
    """`python -m lssvc_tpu_torch.train argv` in a process of its own."""
    from lssvc_tpu_torch import train

    train.main(argv)


def _mode(precision, packed_width=1, packed_ctx=False, int8_table=None):
    from lssvc_tpu_torch.ops.int8 import Int8Sites
    from lssvc_tpu_torch.ops.nn import Mode

    return Mode(precision, packed_width, packed_ctx=packed_ctx, cache={},
                int8=Int8Sites(dict(int8_table or {})))


def spatial_modes(rank, world, params, frame, el_hw, modes):
    """One P-frame on strips under each of `modes` (keyword sets of
    `ops.nn.Mode`: precision, packed_width, packed_ctx, and int8_table for
    its int8 sites), each in its `precision_scope`, and on rank 0 the
    unsharded frame in the same mode, also with x_bl and x_el moved by 1e-6
    relative (the mode's noise floor): per mode the gathered DPB and bits
    of each."""
    from lssvc_tpu_torch.models import lssvc as lssvc_model
    from lssvc_tpu_torch.ops.nn import precision_scope
    from lssvc_tpu_torch.parallel import spatial

    params = {k: torch.as_tensor(v) for k, v in params.items()}
    x_bl, x_el, dpb = frame
    dpb = {k: torch.as_tensor(v) for k, v in dpb.items()}
    group = dist.group.WORLD
    sh = spatial.h_sharding(group)
    fwd = spatial.make_spatial_forward(group, el_hw, 2.0, (0, 0, 0, 0),
                                       kernel_warps=True, halo=16,
                                       halo_grouped=44)
    out = []
    for mode in modes:
        with precision_scope(_mode(**mode)):
            got, bits = fwd(params, strip(x_bl, rank, world),
                            strip(x_el, rank, world),
                            {k: strip(v, rank, world) for k, v in dpb.items()})
        res = {"dpb": {k: sh.gather(v) for k, v in got.items()},
               "bits": float(bits)}
        if rank == 0:  # unsharded, and with the frame moved by 1e-6
            for key, scale in (("ref", 1.0), ("moved", 1.0 + 1e-6)):
                with torch.no_grad(), precision_scope(_mode(**mode)):
                    ref = lssvc_model.forward_one_frame(
                        params, torch.as_tensor(x_bl) * scale,
                        torch.as_tensor(x_el) * scale,
                        *(dpb[k] for k in DPB_KEYS), el_hw, 2.0,
                        (0, 0, 0, 0))
                res[key] = {"dpb": dict(ref["dpb"]),
                            "bits": float(ref["bit_bl"] + ref["bit_el"])}
        out.append(res)
    return out


def strip_ops(rank, world, heights):
    """Every op with a strip form (`ops/strips.py`), at the shapes the
    models use, on strips of frames `heights` rows tall, against the same
    op on the whole frame: {case: max |error| of the gathered output}."""
    from lssvc_tpu_torch.ops import nn, spatial_ctx, strips, warp
    from lssvc_tpu_torch.ops.int8 import int8_conv2d

    gen = torch.Generator().manual_seed(world)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)

    c = 4
    cases = {
        "conv3x3": lambda t, w3: nn.conv2d(t, w3, None),
        "conv3x3_s2": lambda t, w3: nn.conv2d(t, w3, None, stride=2),
        "conv7x7": lambda t, w3: nn.conv2d(t, w7, None),
        "conv1x1_s2_pad0": lambda t, w3: nn.conv2d(t, w1, None, stride=2,
                                                   padding=0),
        "depthwise3x3": lambda t, w3: nn.conv2d(t, wd, None, groups=c),
        "deconv_s2": lambda t, w3: nn.conv_transpose2d(t, wt, None),
        "deconv_s1": lambda t, w3: nn.conv_transpose2d(
            t, wt, None, stride=1, padding=1, output_padding=0),
        "avg_pool": lambda t, w3: nn.avg_pool2d(t, 2),
        "max_pool": lambda t, w3: nn.max_pool2d(t, 2),
        "pixel_shuffle": lambda t, w3: nn.pixel_shuffle(t, 2),
        "upsample2": lambda t, w3: warp.bilinear_upsample2(t),
        "downsample2": lambda t, w3: warp.bilinear_downsample2(t),
        "resize_x1.5": lambda t, w3: warp.bilinear_resize(
            t, (strips.global_rows(t) * 3 // 2, 15)),
        "pad_top_bottom": lambda t, w3: nn.pad_nhwc(t, (1, 0, 2, 3)),
        "clamp_flow": lambda t, w3: warp.clamp_flow(
            t[..., :2] * 50.0, t.shape[1], t.shape[2]),
        "int8_conv3x3_s2": lambda t, w3: int8_conv2d(
            t, wq, stride=2, s_in=0.05, mult=torch.full((c,), 0.01),
            bias=torch.zeros(c)).float(),
    }
    w1, w3, w7 = (rand(c, c, k, k) for k in (1, 3, 7))
    wd, wt, wq = rand(c, 1, 3, 3), rand(c, c, 3, 3), s8(c, c, 3, 3)
    group = dist.group.WORLD
    out = {}
    for h in heights:
        x = rand(1, h, 10, c)
        for name, op in cases.items():
            want = op(x, w3)
            with spatial_ctx.spatial(group):
                got = strips.gather_rows(op(strip(x, rank, world), w3))
            out[f"{name}_h{h}"] = float((got - want).abs().max()) \
                if got.shape == want.shape else float("inf")
    return out
