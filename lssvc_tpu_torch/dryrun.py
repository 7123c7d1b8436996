"""The multi-rank dry run (the twin of the JAX package's
`__graft_entry__.py` `entry` and `dryrun_multichip`).

    python -m lssvc_tpu_torch.dryrun --n 2 [--device cuda|cpu]
                                     [--backend nccl|gloo]

starts N ranks (torch.multiprocessing, joined over a FileStore in a
temporary directory) and runs on them, at tiny shapes:

1. three data-parallel train steps (`parallel.train.make_sharded_train_step`,
   the `pair` loss at EL 128 / BL 64) on one global batch of N items:
   the loss must fall, and the parameters and optimizer state must be
   bit-equal across the ranks;
2. the spatial forward (`parallel.spatial.make_spatial_forward`,
   kernel_warps=True, halo 8) of one P-frame on H-strips;
3. the x1.5 exactness check: EL 192 / BL 128 on H-strips (halo 16,
   grouped halo 44) against the unsharded forward, both in fp32
   (`precision_scope(Mode("fp32"))`: TF32 off): every DPB value within
   1e-3 (rtol and atol) and the bits within 1e-3 relative, on the CPU
   and on the card.  The relative RMS, the share past the elementwise
   1e-3, and the same of the unsharded frame moved by 1e-6 relative (the
   forward's own spread) are printed;
4. the grouped warp's halo fast path at 64 and 128 rows a rank with halo
   44 and |flow_y| up to 40, against the whole-frame warp within 1e-4
   (the +halo row offset can flip a near-integer bilinear tap).

`--device` is cuda by default: the nccl backend, one card a rank (more
ranks than cards raises); `--backend gloo` lets ranks share a card
(CUDA tensors staged through the host); `--device cpu` takes gloo.  It
never moves to the CPU by itself.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

EL, BL = (128, 128), (64, 64)


def entry(device="cuda"):
    """(fn, example_args): the two-layer LSSVC P-frame forward on tiny
    shapes (the flagship model), from the port's init, on `device`."""
    from .models import lssvc as lssvc_model
    from .models.init import init_lssvc
    from .ops.nn import Mode, precision_scope
    from .utils.platform import resolve_device

    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}

    def fn(params, x_bl, x_el, ref_bl, ref_el):
        with torch.no_grad(), precision_scope(Mode("fp32")):
            out = lssvc_model.forward_one_frame(
                params, x_bl, x_el, ref_bl, ref_el, None, None, EL, 2.0,
                (0, 0, 0, 0))
        return (out["dpb"]["ref_frame_el"], out["dpb"]["ref_frame_bl"],
                out["bit_bl"] + out["bit_el"])

    gen = torch.Generator().manual_seed(0)

    def uni(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    return fn, (params, uni(1, *BL, 3), uni(1, *EL, 3), uni(1, *BL, 3),
                uni(1, *EL, 3))


def _uniform(gen, shape, dev, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)


def _dpb(gen, el, bl, dev):
    return {"ref_frame_bl": _uniform(gen, (1, *bl, 3), dev),
            "ref_frame_el": _uniform(gen, (1, *el, 3), dev),
            "ref_feature_bl": _uniform(gen, (1, *bl, 64), dev),
            "ref_feature_el": _uniform(gen, (1, *el, 48), dev)}


def _rank_run(group, dev, log):
    """The dry run's four checks on this rank."""
    from .models import lssvc as lssvc_model
    from .models.init import init_lssvc
    from .ops import warp_kernels as wk
    from .ops.nn import Mode, precision_scope
    from .parallel import spatial
    from .parallel.train import (Adam, make_sharded_train_step,
                                 replicas_equal, train_state_tensors)

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}

    # 1. data-parallel train steps on one batch: the loss must fall
    optimizer = Adam(1e-4)
    opt_state = optimizer.init(params)
    step = make_sharded_train_step(group, optimizer, 0.01, EL)
    gen = torch.Generator().manual_seed(0)
    batch = {"x_bl": _uniform(gen, (n, *BL, 3), dev),
             "x_el": _uniform(gen, (n, *EL, 3), dev),
             "ref_bl": _uniform(gen, (n, *BL, 3), dev),
             "ref_el": _uniform(gen, (n, *EL, 3), dev),
             "lmbda": 0.01}
    losses = []
    p, o = params, opt_state
    for _ in range(3):
        p, o, metrics = step(p, o, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (
        f"sharded train step failed to decrease loss on a fixed batch: "
        f"{losses}")
    assert replicas_equal(train_state_tensors(p, o), group), (
        "parameters or optimizer state differ across ranks")
    log("dryrun_multichip ok:", {k: float(v) for k, v in metrics.items()},
        "loss trajectory:", [round(v, 4) for v in losses],
        "(train state bit-equal on every rank)")

    # 2. the spatial forward on H-strips
    sh = spatial.h_sharding(group)
    gen = torch.Generator().manual_seed(1)
    x_bl, x_el = (_uniform(gen, (1, *BL, 3), dev),
                  _uniform(gen, (1, *EL, 3), dev))
    dpb = _dpb(gen, EL, BL, dev)
    fwd = spatial.make_spatial_forward(group, EL, 2.0, (0, 0, 0, 0),
                                       kernel_warps=True, halo=8)
    spatial.reset_counts()
    launches = wk.flow_warp.launches, wk.grouped_warp.launches
    with precision_scope(Mode("fp32")):
        dpb_s, bits = fwd(params, sh.shard(x_bl), sh.shard(x_el),
                          {k: sh.shard(v) for k, v in dpb.items()})
    assert dpb_s["ref_frame_el"].shape[1] == EL[0] // n
    log("dryrun_multichip spatial ok: bits =", float(bits),
        "warp branches", spatial.branch_counts(), "launches (flow_warp, "
        "grouped_warp)", (wk.flow_warp.launches - launches[0],
                          wk.grouped_warp.launches - launches[1]))

    # 3. x1.5 exactness: EL 192 / BL 128 against the unsharded forward
    el15, bl15 = (192, 192), (128, 128)
    gen = torch.Generator().manual_seed(7)
    x_bl15, x_el15 = (_uniform(gen, (1, *bl15, 3), dev),
                      _uniform(gen, (1, *el15, 3), dev))
    dpb15 = _dpb(gen, el15, bl15, dev)
    fwd15 = spatial.make_spatial_forward(group, el15, 1.5, (0, 0, 0, 0),
                                         kernel_warps=True, halo=16,
                                         halo_grouped=44)
    with precision_scope(Mode("fp32")):
        dpb_s15, bits15 = fwd15(params, sh.shard(x_bl15), sh.shard(x_el15),
                                {k: sh.shard(v) for k, v in dpb15.items()})
        # the unsharded frame, and the same moved by 1e-6 relative
        with torch.no_grad():
            ref15, moved15 = [lssvc_model.forward_one_frame(
                params, x_bl15 * s, x_el15 * s, dpb15["ref_frame_bl"],
                dpb15["ref_frame_el"], dpb15["ref_feature_bl"],
                dpb15["ref_feature_el"], el15, 1.5, (0, 0, 0, 0))
                for s in (1.0, 1.0 + 1e-6)]

    def gap(got, want):
        """(relative RMS, share past 1e-3 + 1e-3 |want|)."""
        d = (got - want).abs()
        return (float(d.norm() / want.norm()),
                float((d > 1e-3 + 1e-3 * want.abs()).float().mean()))

    errs = {k: (*gap(dpb_s15[k], sh.shard(ref15["dpb"][k])),
                *gap(moved15["dpb"][k], ref15["dpb"][k])) for k in dpb15}
    bits_ref15 = float(ref15["bit_bl"] + ref15["bit_el"])
    log("dryrun_multichip spatial x1.5: bits =", float(bits15),
        "vs unsharded", bits_ref15, "(relative RMS and share past 1e-3 "
        "elementwise; the same of the unsharded frame moved by 1e-6:",
        {k: tuple(f"{v:.2e}" for v in e) for k, e in errs.items()}, ")")
    for k, (_, past, _, _) in errs.items():
        assert past == 0, f"x1.5 spatial {k}: relative RMS, share past " \
                          f"1e-3: {errs[k]}"
    assert abs(float(bits15) - bits_ref15) / max(bits_ref15, 1.0) < 1e-3
    log("dryrun_multichip spatial x1.5 exactness ok")

    # 4. the grouped warp's halo fast path at 64 and 128 rows a rank
    g, go = 4, 8
    for rows, seed in ((64, 2), (128, 3)):
        gen = torch.Generator().manual_seed(seed)
        h = rows * n
        xg = _uniform(gen, (1, h, 16, g * 2), dev)
        fxg = _uniform(gen, (1, h, 16, go), dev, -9, 9)
        fyg = _uniform(gen, (1, h, 16, go), dev, -40, 40)
        mg = _uniform(gen, (1, h, 16, go), dev)
        spatial.reset_counts()
        outg = spatial.grouped_warp_sharded_auto(
            *(sh.shard(t) for t in (xg, fxg, fyg, mg)), g, group, halo=44)
        refg = wk.grouped_warp(xg, fxg, fyg, mg, g)
        # atol 1e-4: the +halo offset before floor() can flip a
        # near-integer bilinear tap pair
        torch.testing.assert_close(outg, sh.shard(refg), rtol=1e-4,
                                   atol=1e-4)
        assert spatial.grouped_warp_sharded_auto.strip_calls == 1
        log(f"dryrun_multichip grouped-warp halo fast path ok ({rows} "
            "rows/shard, halo 44)")


def _rank(rank, n, store, device, backend):
    from .parallel.mesh import make_mesh, rank_device

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    dev = rank_device(device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    group = make_mesh(backend=backend, device=dev, rank=rank, world=n,
                      init_method=f"file://{store}")

    def log(*msg):
        if rank == 0:
            print(*msg, flush=True)

    log(f"dryrun_multichip: {n} ranks on {dev} ({dist.get_backend(group)})")
    try:
        _rank_run(group, dev, log)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> None:
    """Run the dry run on `n_devices` ranks of `device` ("cuda": nccl, one
    card a rank, unless `backend` is "gloo"; "cpu": gloo)."""
    import torch.multiprocessing as mp

    from .utils.platform import resolve_device

    resolve_device(device)  # no CUDA: raise here, not in every rank
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n_devices, os.path.join(tmp, "store"), device,
                              backend), nprocs=n_devices, join=True)
    print(f"dryrun_multichip: {n_devices} ranks passed", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="ranks")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)


if __name__ == "__main__":
    main()
