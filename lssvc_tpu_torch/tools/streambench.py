"""Real-bitstream serving benchmark of the port (the twin of the JAX
package's `tools/streambench.py`): the pipelined encoder against the
sequential one, and the overlapped decoder against the sequential one.

    python -m lssvc_tpu_torch.tools.streambench [--frames 8]
        [--hw 1152x1920] [--mode bf16] [--device cuda]

A two-layer LSSVCExtend from the port's random init (seed 0; EL at --hw,
BL at half of it, OffsetDiversity's cap `LSSVC_OD_OFFSET_CAP`, 10 px
unless set) codes --frames P-frames of uniform noise from a random DPB:

  sequential encode : per frame each layer's `compress` and its .bin
                      write, the host rANS blocking the card;
  pipelined encode  : `models.pipeline.encode_sequence`, the host rANS on
                      a worker thread; its files must equal the
                      sequential ones byte for byte;
  overlapped decode : `models.pipeline.decode_sequence` on those files;
  sequential decode : per frame each layer's `decompress`;

both encoders and both decoders with the runner's inter-frame DPB clamp.
The decoders' final DPBs must equal the encoders', bit for bit.  Each
path runs one frame first to warm up.  Prints the ms a frame of each and
the speedups on stderr, then one JSON line.  `--mode` is the CLIs'
precision: fp32, high or bf16.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..models import pipeline
from ..models.dmc_stream import _sync
from ..models.init import init_lssvc
from ..models.lssvc_stream import LSSVCExtend
from ..ops.nn import od_offset_cap_from_env
from ..utils.host import clamp_dpb
from ..utils.platform import resolve_device
from ..utils.stream import decode_p, encode_p, filesize

SEED = 0
DPB_KEYS = ("ref_frame_bl", "ref_feature_bl", "ref_frame_el",
            "ref_feature_el")


def load_model(mode, el_hw, device):
    """The benchmark's LSSVCExtend in precision `mode`, tables built,
    scale set."""
    model = LSSVCExtend(init_lssvc(torch.Generator().manual_seed(SEED)),
                        device=device, od_offset_cap=od_offset_cap_from_env(),
                        precision=mode)
    model.set_scale_information(2.0, el_hw, (0, 0, 0, 0))
    model.update(force=True)
    return model


def make_inputs(el_hw, frames, device):
    """(frames [(x_bl, x_el), ...], the first DPB), uniform noise from a
    seeded generator on the host."""
    bl_hw = (el_hw[0] // 2, el_hw[1] // 2)
    gen = torch.Generator().manual_seed(SEED)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen).to(device)

    xs = [(uni(*bl_hw, 3), uni(*el_hw, 3)) for _ in range(frames)]
    dpb = {"ref_frame_bl": uni(*bl_hw, 3), "ref_feature_bl": uni(*bl_hw, 64),
           "ref_frame_el": uni(*el_hw, 3), "ref_feature_el": uni(*el_hw, 48)}
    return xs, dpb


def paths(folder, tag, n):
    folder = Path(folder)
    return ([folder / f"{tag}_bl{t}.bin" for t in range(n)],
            [folder / f"{tag}_el{t}.bin" for t in range(n)])


def encode_sequential(model, xs, dpb, bl_paths, el_paths):
    """Each frame: the BL's `compress` and file, the EL's; the runner's
    clamp.  Returns (final DPB, bits)."""
    bl, bits = model.base_layer_model, []
    for (x_bl, x_el), pb, pe in zip(xs, bl_paths, el_paths):
        enc_bl = bl.compress(x_bl, dpb)
        encode_p(enc_bl["string"], pb)
        layer = enc_bl["dpb"]
        enc_el = model.compress(x_el, dict(
            dpb, texture=layer["ref_feature_bl"], y_hat_bl=layer["y_hat_bl"],
            mv_hat_bl=layer["mv_hat_bl"]))
        encode_p(enc_el["string"], pe)
        bits.append((filesize(pb) * 8, filesize(pe) * 8))
        dpb = clamp_dpb({
            "ref_frame_bl": layer["ref_frame_bl"],
            "ref_feature_bl": layer["ref_feature_bl"],
            "ref_frame_el": enc_el["dpb"]["ref_frame_el"],
            "ref_feature_el": enc_el["dpb"]["ref_feature_el"]})
    return dpb, bits


def decode_sequential(model, bl_paths, el_paths, dpb, el_hw):
    """Each frame: the BL's `decompress`, then the EL's; the runner's
    clamp.  Returns the final DPB."""
    bl_hw = (el_hw[0] // 2, el_hw[1] // 2)
    bl = model.base_layer_model
    for pb, pe in zip(bl_paths, el_paths):
        layer = bl.decompress(decode_p(pb), *bl_hw, dpb)["dpb"]
        el = model.decompress(decode_p(pe), *el_hw, dict(
            dpb, texture=layer["ref_feature_bl"], y_hat_bl=layer["y_hat_bl"],
            mv_hat_bl=layer["mv_hat_bl"]))["dpb"]
        dpb = clamp_dpb({
            "ref_frame_bl": layer["ref_frame_bl"],
            "ref_feature_bl": layer["ref_feature_bl"],
            "ref_frame_el": el["ref_frame_el"],
            "ref_feature_el": el["ref_feature_el"]})
    return dpb


def _timed(device, fn, *args):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return time.perf_counter() - t0, out


def run(el_hw=(1152, 1920), frames=8, mode="bf16", device="cuda",
        folder=None, counted=contextlib.nullcontext):
    """The benchmark (module docstring); returns its result dict.  The
    files go under `folder` (a temporary directory if None).  `counted`
    is a context manager entered around the pipelined encode and the
    overlapped decode together (and nothing else)."""
    device = resolve_device(device)
    model = load_model(mode, el_hw, device)
    xs, dpb0 = make_inputs(el_hw, frames, device)
    bl_hw = (el_hw[0] // 2, el_hw[1] // 2)
    with contextlib.ExitStack() as stack:
        if folder is None:
            folder = stack.enter_context(tempfile.TemporaryDirectory())
        Path(folder).mkdir(parents=True, exist_ok=True)
        # warm up both encoders and both decoders on one frame
        warm = paths(folder, "warm", 1)
        encode_sequential(model, xs[:1], dict(dpb0), *warm)
        pipeline.encode_sequence(model, *zip(*xs[:1]), dict(dpb0),
                                 *paths(folder, "warm_pip", 1))
        decode_sequential(model, *warm, dict(dpb0), el_hw)
        pipeline.decode_sequence(model, *warm, dict(dpb0), *bl_hw, *el_hw)

        seq = paths(folder, "seq", frames)
        pip = paths(folder, "pip", frames)
        t_seq, (dpb_seq, bits_seq) = _timed(
            device, encode_sequential, model, xs, dict(dpb0), *seq)
        with counted():
            t_pip, (dpb_pip, bits_pip) = _timed(
                device, pipeline.encode_sequence, model,
                [x[0] for x in xs], [x[1] for x in xs], dict(dpb0), *pip)
            t_ovl, dpb_ovl = _timed(device, pipeline.decode_sequence, model,
                                    *pip, dict(dpb0), *bl_hw, *el_hw)
        t_dec, dpb_dec = _timed(device, decode_sequential, model, *seq,
                                dict(dpb0), el_hw)
        differ = [p.name for p, q in zip(seq[0] + seq[1], pip[0] + pip[1])
                  if p.read_bytes() != q.read_bytes()]
    if differ or bits_seq != bits_pip:
        raise AssertionError(f"pipelined streams differ from the sequential "
                             f"encoder's: {differ}")
    for name, dpb in (("pipelined encoder", dpb_pip),
                      ("overlapped decoder", dpb_ovl),
                      ("sequential decoder", dpb_dec)):
        bad = [k for k in DPB_KEYS if not torch.equal(dpb[k], dpb_seq[k])]
        if bad:
            raise AssertionError(f"{name}'s final DPB differs from the "
                                 f"sequential encoder's at {bad}")
    ms = {k: 1e3 * t / frames for k, t in (
        ("sequential_encode", t_seq), ("pipelined_encode", t_pip),
        ("sequential_decode", t_dec), ("overlapped_decode", t_ovl))}
    return {"frames": frames, "el": list(el_hw), "bl": list(bl_hw),
            "mode": mode, "ms_per_frame": ms,
            "encode_speedup": t_seq / t_pip, "decode_speedup": t_dec / t_ovl,
            "bits_per_frame": sum(b + e for b, e in bits_seq) / frames,
            "bins_byte_equal": True, "final_dpb_bit_equal": True,
            "final_dpb": dpb_ovl}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--hw", default="1152x1920", help="EL height x width")
    p.add_argument("--mode", default="bf16",
                   choices=["fp32", "high", "bf16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    el_hw = tuple(int(v) for v in args.hw.split("x"))
    res = run(el_hw, args.frames, args.mode, args.device)
    ms = res["ms_per_frame"]
    print(f"frames={args.frames} el_hw={el_hw} mode={args.mode} "
          f"avg_bits/frame={res['bits_per_frame']:.0f}", file=sys.stderr)
    for k, v in ms.items():
        print(f"{k:18s}: {v:8.1f} ms/frame", file=sys.stderr)
    print(f"encode speedup {res['encode_speedup']:.2f}x, decode speedup "
          f"{res['decode_speedup']:.2f}x", file=sys.stderr)
    line = {k: v for k, v in res.items() if k != "final_dpb"}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
