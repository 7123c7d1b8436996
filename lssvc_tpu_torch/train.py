"""Training CLI for the two-layer codec: the twin of the JAX package's
`train.py`, on one device (the GPU unless `--device cpu`), or
data-parallel when torchrun starts it.

Every flag of `train.py` with its default, plus `--device`.  Frame pairs
(or, for `--loss cascade`, short sequences) come from a directory of YUV
sequences (random temporal windows and aligned random crops) or from a
synthetic generator (`--data synthetic`, no dataset needed); the BL inputs
are the MATLAB-bicubic half-size downsample.  Each step is
`parallel.train.make_train_step`: the RD loss's gradient by autograd (the
warps' by the hand-written backward kernels on the GPU) and the port's
Adam, which follows optax's arithmetic.

`--scan-steps K` keeps the JAX trainer's draw order: with K > 1 the
batches of K steps are drawn in one generator call and a `--stage cascade`
run alternates its warm and first-P chains chunk by chunk; with K = 1 it
draws per step and alternates step by step.  Here a chunk is K eager
steps.  Checkpoints (`checkpoint.py`) are written in the JAX layouts: the
`.state.npz` first and the `.npz` last, and exiting 0 means
`{out}_step{steps}.npz` exists.

Data parallelism (the JAX trainer's mesh, `train.py:305-306,376-407`):
under torchrun (its environment says so; no flag) each rank holds the
parameters, `--batch-per-device` is the batch a rank, the global batch is
that times the world size, every rank draws the same global batch and
differentiates its rows (`parallel.train.make_sharded_train_step`: one
all-reduce of the gradients a step), and only rank 0 logs and writes
checkpoints.  `--device cuda` takes `cuda:{LOCAL_RANK % device_count}` and
the nccl backend (one card a rank), `--device cpu` gloo.  A world of 1
writes the plain run's checkpoint bit for bit.

Example:
  python -m lssvc_tpu_torch.train --steps 1000 --lmbda 0.01 --crop 256
  python -m lssvc_tpu_torch.train --device cpu --crop 128 --steps 2
  python -m torch.distributed.run --nproc_per_node 8 -m lssvc_tpu_torch.train
"""

from __future__ import annotations

import argparse
import faulthandler
import glob
import os
import time

import numpy as np
import torch

from .utils.launch_counts import dump_at_exit_from_env
from .utils.resize import imresize


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="synthetic",
                   help="directory of .yuv sequences, or 'synthetic'")
    p.add_argument("--width", type=int, default=448,
                   help="source YUV width (for --data dirs)")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--crop", type=int, default=256,
                   help="EL crop size (must be divisible by 128 for x2)")
    p.add_argument("--batch-per-device", type=int, default=1)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lmbda", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--out", type=str, default="checkpoints/lssvc")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--freeze", type=str, default=None,
                   choices=[None, "prediction", "other"],
                   help="freeze the motion-prediction subnets or everything "
                        "else (the reference's selective-freeze stages)")
    p.add_argument("--loss", type=str, default="pair",
                   choices=["pair", "warp", "spynet", "cascade", "intra"],
                   help="pair = single P-frame RD; warp = motion-stage loss "
                        "(distortion on the warped prediction); spynet = "
                        "photometric flow pretraining; cascade = "
                        "multi-frame DPB-chain RD; intra = IntraSS two-layer "
                        "RD + quantile aux loss")
    p.add_argument("--precision", type=str, default="high",
                   choices=["fp32", "high", "bf16"],
                   help="compute precision: fp32 = full f32; high (default) "
                        "= TF32 convolutions and matmuls on the GPU; bf16 = "
                        "bf16 conv operands and outputs (parameters and "
                        "optimizer state stay f32 either way)")
    p.add_argument("--frames", type=int, default=4,
                   help="chain length T for --loss cascade (frame 0 is the "
                        "uncompressed reference, T-1 frames are coded)")
    p.add_argument("--stage", type=str, default=None,
                   choices=[None, "spynet", "mv", "full", "cascade"],
                   help="staged recipe preset: spynet = photometric flow "
                        "pretraining; mv = freeze 'other', warp loss; full "
                        "= pair loss; cascade = multi-frame loss.  Overrides "
                        "--loss/--freeze.")
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="if >0, cosine-decay the LR to lr/100 over this "
                        "many steps")
    p.add_argument("--skip-if-done", action="store_true",
                   help="exit 0 at once when {out}_step{steps}.npz exists")
    p.add_argument("--scan-steps", type=int, default=0,
                   help="steps per chunk: the batches of a chunk are drawn "
                        "in one generator call (the JAX trainer's lax.scan "
                        "chunk; here K eager steps); 1 = draw per step; "
                        "0 = 8")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu for a run without "
                        "a GPU)")
    args = p.parse_args(argv)
    if args.scan_steps <= 0:
        args.scan_steps = 8
    args.cascade_warm = 0
    if args.stage == "cascade":
        # only `cap` frames of the chain take gradients
        # (LSSVC_CASCADE_FRAMES, 2 by default, as the JAX trainer); the
        # frames before them are forward-only DPB warm-up steps, so the
        # steps with a loss train the steady-state P-frame
        cap = int(os.environ.get("LSSVC_CASCADE_FRAMES", "2"))
        if args.frames > cap:
            args.cascade_warm = args.frames - cap
            if os.environ.get("RANK", "0") == "0":  # one rank logs
                print(f"cascade: {args.cascade_warm} forward-only DPB "
                      f"warm-up step(s) + {cap - 1} gradient step(s) "
                      f"(grad-frame cap {cap}; set LSSVC_CASCADE_FRAMES to "
                      "raise)", flush=True)
    return args


def resume_policy(tag: str, step0: int, out: str, steps: int) -> str:
    """Classify a --resume with an existing sibling .state.npz: "crash" (the
    same stage: restore the optimizer, the schedule's position and the
    step) or "stage" (a handoff between stages: params only, a fresh
    optimizer, step 0).  The state's out_tag decides; an untagged state
    saved at a step >= this run's --steps can only be a finished other
    stage."""
    if tag and tag != out:
        return "stage"
    if not tag and step0 >= steps:
        return "stage"
    return "crash"


class SyntheticPairs:
    """Correlated frame pairs and sequences: smooth textures translated at a
    constant velocity per sequence (the JAX trainer's generator, draw for
    draw)."""

    def __init__(self, crop, seed=0):
        self.crop = crop
        self.rng = np.random.default_rng(seed)

    def _smooth_texture(self, n, h, w):
        """Low-frequency random texture (white noise is incompressible and
        cannot be warped: no training signal)."""
        small = self.rng.random((n, h // 8 + 2, w // 8 + 2, 3)).astype(
            np.float32)
        from scipy.ndimage import zoom

        up = np.stack([zoom(s, (8, 8, 1), order=1)[:h, :w] for s in small])
        return np.clip(up, 0, 1)

    def next_sequences(self, n, t, max_v=3):
        """(n, t, crop, crop, 3) sequences, constant per-sequence motion."""
        c = self.crop
        m = max_v * (t - 1) + 1
        base = self._smooth_texture(n, c + 2 * m, c + 2 * m)
        out = np.empty((n, t, c, c, 3), dtype=np.float32)
        for i in range(n):
            vx, vy = self.rng.integers(-max_v, max_v + 1, 2)
            for j in range(t):
                y0, x0 = m + vy * j, m + vx * j
                out[i, j] = base[i, y0:y0 + c, x0:x0 + c]
        out += 0.01 * self.rng.standard_normal(out.shape).astype(np.float32)
        return np.clip(out, 0, 1)

    def next_batch(self, n):
        seq = self.next_sequences(n, 2)
        return seq[:, 0], seq[:, 1]


class YUVPairs:
    """Random temporal windows with aligned random crops from a directory of
    8-bit 4:2:0 .yuv files (the JAX trainer's reader, draw for draw)."""

    def __init__(self, root, width, height, crop, seed=0):
        self.files = sorted(glob.glob(os.path.join(root, "**", "*.yuv"),
                                      recursive=True))
        frame_bytes = width * height * 3 // 2
        short = [f for f in self.files if os.path.getsize(f) < frame_bytes]
        if short:
            print(f"YUVPairs: skipping {len(short)} file(s) shorter than "
                  f"one {width}x{height} frame, e.g. {short[0]}")
            self.files = [f for f in self.files if f not in set(short)]
        if not self.files:
            raise FileNotFoundError(
                f"no usable .yuv under {root} (>= one frame at "
                f"{width}x{height})")
        self.width = width
        self.height = height
        self.crop = crop
        self.rng = np.random.default_rng(seed)

    def _read_frames(self, path, t):
        from .utils.color import ycbcr420_to_rgb
        from .utils.io import YUVReader

        frame_bytes = self.width * self.height * 3 // 2
        n_frames = os.path.getsize(path) // frame_bytes
        t0 = int(self.rng.integers(0, max(n_frames - t + 1, 1)))
        r = YUVReader(path, self.width, self.height, skip_frame=t0)
        frames = []
        try:
            for _ in range(t):
                y, uv = r.read_one_frame()
                if y is None:
                    if not frames:
                        raise ValueError(
                            f"{path}: no complete frame at {self.width}x"
                            f"{self.height} (truncated file or wrong "
                            "--width/--height)")
                    frames.append(frames[-1])
                else:
                    frames.append(ycbcr420_to_rgb(y, uv).transpose(1, 2, 0))
        finally:
            r.close()
        return frames

    def next_sequences(self, n, t):
        c = self.crop
        out = []
        for _ in range(n):
            path = self.files[int(self.rng.integers(len(self.files)))]
            frames = self._read_frames(path, t)
            h, w, _ = frames[0].shape
            y = int(self.rng.integers(0, max(h - c, 1)))
            x = int(self.rng.integers(0, max(w - c, 1)))
            out.append(np.stack([f[y:y + c, x:x + c] for f in frames]))
        return np.stack(out)

    def next_batch(self, n):
        seq = self.next_sequences(n, 2)
        return seq[:, 0], seq[:, 1]


def downsample_bl(x_el):
    """BL inputs: the MATLAB-bicubic half-size downsample of (..., H, W, 3)
    in [0, 1], as the evaluation path makes them."""
    lead = tuple(x_el.shape[:-3])
    flat = x_el.reshape((-1,) + tuple(x_el.shape[-3:]))
    bl = torch.clamp(imresize(flat.permute(0, 3, 1, 2), scale=0.5), 0, 1)
    bl = bl.permute(0, 2, 3, 1).contiguous()
    return bl.reshape(lead + tuple(bl.shape[1:]))


def make_batch(data, loss: str, nb: int, frames: int, device):
    """One batch of nb items from `data` (SyntheticPairs or YUVPairs) on
    `device`: (batch dict, frames coded an item).  cascade: x_bl, x_el of
    (nb, frames, H, W, 3); intra: x_bl, x_el; else x_bl, x_el, ref_bl,
    ref_el."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if loss == "cascade":
        seq = dev(data.next_sequences(nb, frames))
        return {"x_bl": downsample_bl(seq), "x_el": seq}, frames - 1
    if loss == "intra":
        _, x_el = data.next_batch(nb)
        x_el = dev(x_el)
        return {"x_bl": downsample_bl(x_el), "x_el": x_el}, 1
    ref_el, x_el = data.next_batch(nb)
    x_el, ref_el = dev(x_el), dev(ref_el)
    return {"x_bl": downsample_bl(x_el), "x_el": x_el,
            "ref_bl": downsample_bl(ref_el), "ref_el": ref_el}, 1


def apply_stage(args):
    """The staged recipe's presets (`dmc_net.py:283-350`): MV stage first
    (motion subnets only, warp loss), then single-frame RD, then the
    multi-frame chain; spynet pretrains the flow nets."""
    if args.stage == "spynet":
        args.loss, args.freeze = "spynet", None
    elif args.stage == "mv":
        args.loss, args.freeze = "warp", "other"
    elif args.stage == "full":
        args.loss, args.freeze = "pair", None
    elif args.stage == "cascade":
        args.loss, args.freeze = "cascade", None


def main(argv=None):
    args = parse_args(argv)
    dump_at_exit_from_env()

    if args.skip_if_done:
        done = f"{args.out}_step{args.steps}.npz"
        if os.path.exists(done):
            print(f"{done} exists; --skip-if-done -> nothing to do")
            return

    # a stalled run dumps every thread's stack after 10 silent minutes
    faulthandler.enable()
    faulthandler.dump_traceback_later(600, repeat=True)

    from .checkpoint import (load_params, load_train_state, read_ckpt_meta,
                             save_params, save_train_state)
    from .entropy.models import refit_quantiles
    from .models.base import label_params
    from .models.init import init_intra_ss, init_lssvc
    from .parallel.scheduler import BL_CHANNEL_KEY, _checked, _shapes
    import torch.distributed as dist

    from .parallel.mesh import launched, make_mesh, rank_device, world_of
    from .parallel.train import (Adam, cosine_decay_schedule,
                                 make_sharded_train_step, make_train_step,
                                 scan)
    from .utils.platform import resolve_device

    apply_stage(args)
    # under torchrun (or in a process group a caller started): one rank of a
    # data-parallel run
    parallel = launched() or dist.is_initialized()
    own_group = parallel and not dist.is_initialized()
    group = None
    if parallel:
        device = rank_device(args.device)
        group = make_mesh(device=device)
    else:
        device = resolve_device(args.device)
    rank, world = world_of(group)
    lead = rank == 0

    def say(*msg, **kw):
        if lead:
            print(*msg, **kw)

    batch = args.batch_per_device * world  # the global batch
    if parallel and lead:
        print(f"data-parallel: {world} rank(s), global batch {batch}",
              flush=True)
    crop = args.crop
    if crop % 128:
        raise SystemExit(f"--crop {crop}: the EL crop must be divisible by "
                         "64 * ratio (= 128)")
    kind = "intra_ss" if args.loss == "intra" else "lssvc"

    def held(params, path):
        """A checkpoint's params held to the model's keys and shapes."""
        if kind == "intra_ss":
            shapes = _shapes(init_intra_ss,
                             int(params[BL_CHANNEL_KEY].shape[0]))
        else:
            shapes = _shapes(init_lssvc)
        return {k: v.to(device) for k, v in
                _checked({k: v.cpu() for k, v in params.items()}, shapes,
                         path).items()}

    gen = torch.Generator().manual_seed(args.seed)
    if args.resume:
        params = held(load_params(args.resume, kind)[0], args.resume)
        say(f"resumed from {args.resume}")
    elif kind == "intra_ss":
        params = {k: v.to(device) for k, v in init_intra_ss(gen).items()}
    else:
        params = {k: v.to(device) for k, v in init_lssvc(gen).items()}

    lr = (cosine_decay_schedule(args.lr, args.lr_decay_steps, alpha=0.01)
          if args.lr_decay_steps > 0 else args.lr)
    optimizer = Adam(lr, labels=label_params(params) if args.freeze else None,
                     frozen=args.freeze)
    opt_state = optimizer.init(params)

    # a sibling .state.npz of the same run (its out_tag) restores the Adam
    # moments, the schedule's position and the step; another run's is a
    # stage handoff: params only, a fresh optimizer, step 0
    step0 = 0
    if args.resume:
        state_path = (args.resume if args.resume.endswith(".state.npz")
                      else args.resume[:-len(".npz")] + ".state.npz")
        if os.path.exists(state_path):
            meta = read_ckpt_meta(state_path)
            tag = str(meta.get("out_tag", ""))
            saved_step = int(meta.get("step", 0))
            policy = resume_policy(tag, saved_step, args.out, args.steps)
            if policy == "stage":
                say(f"state {state_path} (stage '{tag or 'untagged'}', "
                    f"step {saved_step}) is a cross-stage handoff: "
                    f"params only, fresh optimizer, step 0")
            else:
                p_s, o_s, s_s = load_train_state(state_path, kind)
                if o_s is None or set(o_s["mu"]) != set(opt_state["mu"]):
                    say(f"state restore failed ({state_path} holds no "
                        "optimizer state of this run); params-only resume")
                else:
                    params = held(p_s, state_path)
                    opt_state = {"count": o_s["count"],
                                 "mu": {k: v.to(device)
                                        for k, v in o_s["mu"].items()},
                                 "nu": {k: v.to(device)
                                        for k, v in o_s["nu"].items()}}
                    step0 = s_s
                    say(f"restored optimizer state + step {step0} "
                        f"from {state_path}")
        else:
            say("params-only resume (fresh optimizer state)")

    scan_k = max(args.scan_steps, 1)
    shape_hr = (crop, crop)

    def make_step(warm):
        if parallel:
            return make_sharded_train_step(group, optimizer, args.lmbda,
                                           shape_hr, loss=args.loss,
                                           cascade_warm=warm,
                                           precision=args.precision)
        return make_train_step(optimizer, args.lmbda, shape_hr,
                               loss=args.loss, cascade_warm=warm,
                               precision=args.precision)

    step_fn = make_step(args.cascade_warm)
    # a warm cascade also trains plain short chains (the first P-frame of
    # every GOP runs without features), alternating with the warm ones
    alt_fn = None
    if args.loss == "cascade" and args.cascade_warm > 0:
        alt_fn = make_step(0)

    if args.data == "synthetic":
        data = SyntheticPairs(crop, args.seed)
    else:
        data = YUVPairs(args.data, args.width, args.height, crop, args.seed)

    def host_batch(nb):
        return make_batch(data, args.loss, nb, args.frames, device)

    last = {"step": step0, "t": time.time()}

    def log(step, metrics, fpi):
        faulthandler.dump_traceback_later(600, repeat=True)
        if not lead:
            return
        m = {k: float(v) for k, v in metrics.items()}
        now = time.time()
        rate = (step - last["step"]) * batch * fpi / (now - last["t"])
        last["step"], last["t"] = step, now
        aux = f" aux={m['aux']:.3f}" if "aux" in m else ""
        print(f"step {step}: loss={m['loss']:.4f} bpp={m['bpp']:.4f} "
              f"mse_el={m['mse_el']:.6f}{aux} ({rate:.2f} frames/s)",
              flush=True)

    if lead:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def save_ckpt(path, params, opt_state, label):
        if not lead:  # the ranks hold the same state; rank 0 writes it
            return
        # an intra checkpoint's quantiles are re-solved exactly: the stream's
        # CDF tables come from them, and the aux loss is far from converged
        saved = refit_quantiles(params) if args.loss == "intra" else params
        # the state first, the .npz (a stage's done marker) last
        save_train_state(path[:-len(".npz")] + ".state.npz", params, kind,
                         opt_state, label, out_tag=args.out)
        save_params(path, saved, kind, metadata={"step": label})
        print(f"saved {path}")

    if scan_k > 1:
        # a chunk's batches are drawn in one generator call (scan_k * batch
        # items) and split into scan_k steps
        step = step0
        chunk = 0
        while step < args.steps:
            bd, fpi = host_batch(scan_k * batch)
            bd = {k: v.reshape((scan_k, batch) + tuple(v.shape[1:]))
                  for k, v in bd.items()}
            fn = step_fn
            if alt_fn is not None and chunk % 2 == 1:
                # first-P chunk: the chain truncated to its gradient frames
                gf = args.frames - args.cascade_warm
                bd = {k: v[:, :, :gf] for k, v in bd.items()}
                fn = alt_fn
            params, opt_state, ms = scan(fn)(params, opt_state, bd)
            metrics = {k: v[-1] for k, v in ms.items()}
            chunk += 1
            step += scan_k
            # the chunk may overshoot --steps: the checkpoint carries the
            # requested count
            label = min(step, args.steps)
            if step % args.log_every < scan_k:
                log(step, metrics, fpi)
            if step % args.save_every < scan_k or step >= args.steps:
                save_ckpt(f"{args.out}_step{label}.npz", params, opt_state,
                          label)
    else:
        for step in range(step0 + 1, args.steps + 1):
            batch_dict, fpi = host_batch(batch)
            fn = step_fn
            if alt_fn is not None and step % 2 == 0:
                gf = args.frames - args.cascade_warm
                batch_dict = {k: v[:, :gf] for k, v in batch_dict.items()}
                fn = alt_fn
            params, opt_state, metrics = fn(params, opt_state, batch_dict)
            if step % args.log_every == 0:
                log(step, metrics, fpi)
            if step % args.save_every == 0 or step == args.steps:
                save_ckpt(f"{args.out}_step{step}.npz", params, opt_state,
                          step)

    # exiting 0 means {out}_step{steps}.npz exists, even when the loop ran
    # no step (a resume at step >= --steps)
    final = f"{args.out}_step{args.steps}.npz"
    if lead and not os.path.exists(final):
        save_ckpt(final, params, opt_state, args.steps)
    if parallel:
        dist.barrier(group)
        if own_group:
            dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    main()
