"""The two-layer P-frame chain benchmark of the port (the twin of the root
`bench.py`): frames a second, one JSON line.

    python -m lssvc_tpu_torch.bench [--mode bf16_packed] [--batch 1]
        [--staged] [--tier-stats] [--video synthetic] [--ckpt video.pth]
        [--frames 7] [--size 1152x1920] [--device cuda]

Method (`bench.py:1-33`): K sequential two-layer frame forwards (BL DMC +
EL LSSVC, encoder and decoder network math with estimated bits) with the
decoded-picture buffer fed back between calls, and one scalar bit count
read at the end, which waits for all K frames.  A reading is
(t(1 + K frames) - t(1 frame)) / K, so fixed costs cancel; readings repeat
until two in a row agree within 10%.

Modes (`bench.py:86-115`): `bf16` (bf16 conv operands and outputs, f32
accumulation), `fp32` (the parity mode), `high` (TF32 convs and
matmuls), `bf16_f32out` (bf16 operands, f32 outputs), `bf16_packed`
(the command line's default, as the root bench's: `bf16` with the
width-packed full-res stacks; `LSSVC_PACKED_CTX=1` adds the fused
packed pair warp), `bf16_einsum` (1x1 convs as matmuls),
`bf16_packed_einsum`, `int8_packed` (`bf16_packed` with the s8
convolution at the calibrated sites: it calibrates itself first, at
512x512 over 2 frames, `harness/calibrate.py`, and prints the table's and
the served sites' counts to stderr, as `bench.py:192-210,279-281` does).
OffsetDiversity's offset cap is `LSSVC_OD_OFFSET_CAP` px (10 unless set; 0
or empty: none).

`vs_baseline` is against the reference's own GPU time, 1.44 s encode +
1.35 s decode a two-layer 1080p P-frame (`BASELINE.md:23-24`).  Besides the
root bench's keys the line carries the mode, the seconds a frame, the
peak device memory (GiB, CUDA only), the chain's bits and the frames the
whole run coded (warm-up and readings); `int8_packed`
adds the table's sites, the sites served and the served site calls of the
whole run.

`--profile DIR` (`bench.py:282-286`) runs one steady chain of min(K, 3)
frames after the warm-up under torch.profiler (CPU activity, and CUDA on
the card), writes its Chrome trace to `DIR/<mode>_trace.json`, prints the
top kernels by device time (on the CPU: the top operators by CPU time) to
stderr, adds a `profile` summary to the line (the device time of all
kernels, of `int8_conv`'s and its share; per frame), and goes on with the
readings.

`--staged`, or `--batch` > 1 (`bench.py:133-138`), times the four-stage
frame (`LSSVC.forward_one_frame_staged3`: BL | EL contexts | EL residual
| EL recon) with K capped at 2; the line says `"staged": true`.  In the
port that frame is the fused frame (eager PyTorch has no program
boundary to stage at, `models/lssvc.py`), so `--staged` differs only by
its K cap; the JAX package stages to fit a batch into a 16 GB chip.  `--tier-stats` (`bench.py:222-244`) first codes 3 frames and
prints to stderr, for each, max |mv_x| and max |mv_y| of the EL's
decoded motion with the warp tier the JAX package would pick for it:
`tiny` (both <= 2 px), `windowed` (<= 62 px across, <= 26 px down) or
`fallback`.  The port's `flow_warp` is one exact kernel for every
magnitude, so the tier is only a label.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .harness.calibrate import calibrate_video
from .models import LSSVC
from .models.init import init_lssvc
from .ops.nn import od_offset_cap_from_env, packed_ctx_from_env
from .utils.platform import resolve_device
from .utils.resize import imresize

BASELINE_FPS = 1.0 / (1.44 + 1.35)
MODES = {
    "bf16": dict(precision="bf16"),
    "fp32": dict(precision="fp32"),
    "high": dict(precision="high"),
    "bf16_f32out": dict(precision="bf16_f32out"),
    "bf16_packed": dict(precision="bf16", packed_width=2),
    "bf16_einsum": dict(precision="bf16", conv1x1_einsum=True),
    "bf16_packed_einsum": dict(precision="bf16", packed_width=2,
                               conv1x1_einsum=True),
    "int8_packed": dict(precision="int8", packed_width=2),
}
# `--staged` and `--batch` > 1 cap K here (`bench.py:133-138`)
STAGED_MAX_K = 2
TIER_STATS_FRAMES = 3
PROFILE_FRAMES, PROFILE_TOP = 3, 15
# int8_packed's own calibration: EL size and frames (`bench.py:198-201`)
CALIB_SIZE, CALIB_FRAMES = 512, 2
SEED = 0


def synthetic_motion_frames(el_hw, n_frames, seed=7):
    """n_frames of (H, W, 3) f32 in [0, 1]: a smooth texture with a ~1.5
    px/frame global pan and a faster-moving square (`bench.py:39-66`)."""
    from scipy import ndimage

    h, w = el_hw
    rng = np.random.default_rng(seed)
    small = rng.random((h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    base = ndimage.zoom(small, (16, 16, 1), order=1)[:h, :w]
    sq = h // 8
    frames = []
    for t in range(n_frames):
        f = np.roll(base, (int(1.5 * t) % h, int(1.5 * t) % w), axis=(0, 1))
        y0 = (h // 4 + 3 * t) % (h - sq)
        x0 = (w // 4 + 4 * t) % (w - sq)
        f = f.copy()
        f[y0:y0 + sq, x0:x0 + sq] = rng.random(3).astype(np.float32)
        frames.append(np.clip(f, 0.0, 1.0))
    return frames


def warp_tier(mv_x, mv_y):
    """The JAX package's warp tier for flows of these largest magnitudes
    (px): tiny <= 2, windowed <= 62 across and <= 26 down, else fallback
    (`bench.py:222-244`)."""
    if max(mv_x, mv_y) <= 2.0:
        return "tiny"
    if mv_x <= 62 and mv_y <= 26:
        return "windowed"
    return "fallback"


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"--mode {mode!r}: expected one of {list(MODES)}")


def model_for(mode, params, device):
    """The LSSVC of a bench mode, with the CLIs' environment presets;
    `int8_packed` calibrates first (512x512, 2 frames, the serving cap)."""
    check_mode(mode)
    kw = dict(MODES[mode])
    if kw.get("packed_width") == 2:
        kw["packed_ctx"] = packed_ctx_from_env()
    cap = od_offset_cap_from_env()
    if mode == "int8_packed":
        kw["int8_table"] = calibrate_video(params, size=CALIB_SIZE,
                                           frames=CALIB_FRAMES, device=device,
                                           od_offset_cap=cap)
        print(f"# int8 calibration: {len(kw['int8_table'])} conv sites",
              file=sys.stderr)
    return LSSVC(params, device=device, od_offset_cap=cap, **kw)


def load_params(ckpt):
    if ckpt is None:
        return init_lssvc(torch.Generator().manual_seed(SEED))
    from .parallel.scheduler import _checked, _shapes, _state_dict

    return _checked(_state_dict(ckpt, "lssvc"), _shapes(init_lssvc), ckpt)


def chain_inputs(el_hw, k, batch, video, device):
    """The frames [(x_bl, x_el), ...] and the first DPB."""
    bl_hw = (el_hw[0] // 2, el_hw[1] // 2)
    gen = torch.Generator().manual_seed(SEED)

    def uniform(*shape):
        return torch.rand((batch, *shape), generator=gen).to(device)

    if video == "synthetic":
        frames = []
        for f in synthetic_motion_frames(el_hw, k + 2):
            x_el = torch.from_numpy(f).to(device)[None].expand(
                batch, -1, -1, -1).contiguous()
            x_bl = torch.clamp(imresize(x_el.permute(0, 3, 1, 2),
                                        sizes=bl_hw), 0, 1) \
                .permute(0, 2, 3, 1).contiguous()
            frames.append((x_bl, x_el))
        first = frames[0]
    elif video is None:
        frames = [(uniform(*bl_hw, 3), uniform(*el_hw, 3))]
        first = (uniform(*bl_hw, 3), uniform(*el_hw, 3))
    else:
        raise ValueError(f"--video {video!r}: only 'synthetic' is known")
    dpb = {"ref_frame_bl": first[0], "ref_frame_el": first[1],
           "ref_feature_bl": uniform(*bl_hw, 64),
           "ref_feature_el": uniform(*el_hw, 48)}
    return frames, dpb


def _self_us(evt, cuda):
    if not cuda:
        return evt.self_cpu_time_total
    # torch renamed cuda_* timing attributes to device_* in 2.4
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profile_chain(run_chain, frames, trace_dir, mode, cuda):
    """`frames` frames of the chain under torch.profiler: the Chrome trace
    into `trace_dir`, the top kernels (operators on the CPU) to stderr,
    and a summary: the summed device time of the kernels (CPU time of the
    operators on the CPU), int8_conv's part and share, per frame."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        run_chain(frames)
    trace = Path(trace_dir) / f"{mode}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    rows = [e for e in prof.key_averages()
            if e.device_type == kind and _self_us(e, cuda) > 0]
    total = sum(_self_us(e, cuda) for e in rows) / 1e3
    int8 = sum(_self_us(e, cuda) for e in rows if "int8_conv" in e.key) / 1e3
    top = sorted(rows, key=lambda e: _self_us(e, cuda),
                 reverse=True)[:PROFILE_TOP]
    clock = "device" if cuda else "CPU"
    print(f"# profile: {frames} frames of {mode} -> {trace}; {clock} time "
          f"{total / frames:.3f} ms a frame, int8_conv {int8 / frames:.3f} "
          f"ms ({int8 / total if total else 0.0:.1%}); top by {clock} time:",
          file=sys.stderr)
    for e in top:
        print(f"#   {_self_us(e, cuda) / 1e3 / frames:9.3f} ms a frame "
              f"{e.count / frames:7.1f} calls  {e.key[:100]}",
              file=sys.stderr)
    return {"trace": str(trace), "frames": frames, "clock": clock,
            "ms_per_frame": total / frames,
            "int8_conv_ms_per_frame": int8 / frames,
            "int8_conv_share": int8 / total if total else 0.0,
            "top": [{"name": e.key[:100],
                     "ms_per_frame": _self_us(e, cuda) / 1e3 / frames,
                     "calls_per_frame": e.count / frames} for e in top]}


def bench_chain(el_hw=(1152, 1920), k=7, mode="bf16", batch=1, ckpt=None,
                video=None, device="cuda", readings=8, profile=None,
                staged=False, tier_stats=False):
    """Run the chain benchmark; returns its result dict (see the module
    docstring), or raises if no two readings agree.  `staged` (implied by
    `batch` > 1) times the four-stage frame with K capped at 2;
    `tier_stats` prints the EL motion's tiers over 3 frames first.  With
    `profile` (a directory) one steady chain of min(k, 3) frames runs
    under torch.profiler first (`profile_chain`)."""
    check_mode(mode)
    device = resolve_device(device)
    staged = staged or batch > 1
    if staged:
        k = min(k, STAGED_MAX_K)
    model = model_for(mode, load_params(ckpt), device)
    model.set_scale_information(2.0, el_hw, (0, 0, 0, 0))
    frames, dpb0 = chain_inputs(el_hw, k, batch, video, device)
    cuda = device.type == "cuda"
    step = (model.forward_one_frame_staged3 if staged
            else model.forward_one_frame)

    frames_run = [0]

    def run_frames(n):
        dpb = dpb0
        frames_run[0] += n
        for i in range(n):
            x_bl, x_el = frames[(i + 1) % len(frames)]
            out = step(x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
                       dpb["ref_feature_bl"], dpb["ref_feature_el"])
            dpb = out["dpb"]
            yield out

    def run_chain(n):
        bits = torch.zeros((), device=device)
        for out in run_frames(n):
            bits = bits + out["bit_bl"] + out["bit_el"]
        return float(bits)  # resolves only after all n frames

    if tier_stats:
        for i, out in enumerate(run_frames(TIER_STATS_FRAMES)):
            mv = out["mv_hat"].float().abs()
            fx, fy = float(mv[..., 0].max()), float(mv[..., 1].max())
            print(f"# tier-stats frame {i + 1}: max|mv_x|={fx:.2f} "
                  f"max|mv_y|={fy:.2f} -> EL warp tier: {warp_tier(fx, fy)} "
                  "(a label: one exact flow_warp kernel serves every tier)",
                  file=sys.stderr)

    def measure():
        t0 = time.perf_counter()
        run_chain(1)
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        bits = run_chain(1 + k)
        dt = (time.perf_counter() - t0 - t_one) / k
        return (dt, bits) if dt > 0 else None

    run_chain(1)  # warm up: kernels built and loaded, allocator filled
    sites = model.mode.int8
    if mode == "int8_packed":
        print(f"# int8 sites active in step: {len(sites.served)}",
              file=sys.stderr)
    prof = None
    if profile is not None:
        prof = profile_chain(run_chain, min(k, PROFILE_FRAMES), profile,
                             mode, cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    got = []
    for _ in range(readings):
        r = measure()
        if r is None:
            continue
        got.append(r)
        if (len(got) >= 2 and abs(got[-1][0] - got[-2][0])
                <= 0.1 * min(got[-1][0], got[-2][0])):
            dt, bits = min(got[-2:])
            res = {"mode": mode, "s_per_frame": dt, "fps": batch / dt,
                   "bits": bits, "frames": k, "frames_run": frames_run[0],
                   "batch": batch, "staged": staged,
                   "peak_gib": (torch.cuda.max_memory_allocated(device)
                                / 2 ** 30 if cuda else None)}
            if prof is not None:
                res["profile"] = prof
            if mode == "int8_packed":
                res.update(int8_sites=len(sites.table),
                           int8_served=len(sites.served),
                           int8_served_calls=sites.calls)
            return res
    raise RuntimeError(
        f"no two consecutive positive frame-time readings agreed within "
        f"10% (readings: {[round(r[0], 4) for r in got]})")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="bf16_packed")
    p.add_argument("--batch", type=int, default=1,
                   help="sequences a frame; > 1 implies --staged")
    p.add_argument("--staged", action="store_true",
                   help="the four-stage frame, K capped at 2")
    p.add_argument("--tier-stats", action="store_true",
                   help="print the EL motion's largest magnitudes over 3 "
                        "frames and the JAX warp tier they would take (a "
                        "label: the port has one exact kernel for all)")
    p.add_argument("--video", default=None,
                   help="'synthetic': a moving-texture sequence, BL by "
                        "bicubic; default uniform noise")
    p.add_argument("--ckpt", default=None, help="video model (.pth or .npz)")
    p.add_argument("--frames", type=int, default=7, help="K")
    p.add_argument("--size", default="1152x1920",
                   help="EL height x width (1080p padded to 1152x1920)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profile one steady chain of min(K, 3) frames")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    h, w = (int(v) for v in args.size.split("x"))
    res = bench_chain((h, w), k=args.frames, mode=args.mode,
                      batch=args.batch, ckpt=args.ckpt, video=args.video,
                      device=args.device, profile=args.profile,
                      staged=args.staged, tier_stats=args.tier_stats)
    tag = {(1152, 1920): "1080p", (768, 1280): "720p"}.get((h, w),
                                                           f"{h}x{w}")
    line = {"metric": f"two_layer_{tag}_fps_per_chip", "value": res["fps"],
            "unit": "frames/s", "vs_baseline": res["fps"] / BASELINE_FPS}
    line.update(res)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
