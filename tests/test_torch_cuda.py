"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a host without CUDA.  On a GPU host,
`python -m pytest tests/test_torch_cuda.py -q` builds the kernels from
lssvc_tpu_torch/csrc and runs them; nothing here imports JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.harness import runner
from lssvc_tpu_torch.models import LSSVC, IntraSS
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.models.intra_ss_stream import (compress_stream,
                                                    decompress_stream)
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.tools.synthetic import write_dataset
from lssvc_tpu_torch.ops import conv_chain as cc
from lssvc_tpu_torch.ops import int8 as q8
from lssvc_tpu_torch.ops import nn as tnn
from lssvc_tpu_torch.ops import warp as plain
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.tools.warp_bench import deterministic

from torch_threads import share_cores

share_cores()

pytestmark = pytest.mark.cuda
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _uniform(shape, seed, lo, hi, dev, dtype=torch.float32):
    a = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _bits(out, ref):
    """Bit-equal: the kernels repeat the plain arithmetic with explicit
    round-to-nearest operations and round a bf16 result once."""
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


def _misaligned(t):
    """A copy of t at storage offset 1 (one element past alignment)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view(t.shape).copy_(t)


def _flow(shape, seed, amp, dev):
    flow = _uniform(shape[:3] + (2,), seed, -amp, amp, dev)
    flow[-1, 3, 5, 0] = float("nan")
    return flow


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 11, 48, 51, 64, 96])
def test_flow_warp_equals_plain(dev, dtype, c):
    """Batch 2, a row length that is no multiple of the column tile, flows
    past the borders and a NaN; C*elt a multiple of 16 takes the vector
    path, other C the scalar path.  One launch a call."""
    x = _uniform((2, 21, 70, c), c, -1, 1, dev, dtype)
    flow = _flow(x.shape, c + 1, 40, dev)
    n = wk.flow_warp.launches
    out = wk.flow_warp(x, flow)
    assert wk.flow_warp.launches == n + 1
    _bits(out, plain.flow_warp(x, flow))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ca,cb", [(3, 48), (3, 64), (48, 3), (11, 5),
                                   (48, 96), (1, 8)])
def test_flow_warp_pair_equals_two_plain_warps(dev, dtype, ca, cb):
    """One launch for both tensors, each bit-equal to its own plain warp,
    whichever path each takes."""
    a = _uniform((2, 19, 45, ca), ca, -1, 1, dev, dtype)
    b = _uniform((2, 19, 45, cb), cb + 50, -1, 1, dev, dtype)
    flow = _flow(a.shape, ca + cb, 30, dev)
    n = wk.flow_warp.launches
    out_a, out_b = wk.flow_warp_pair(a, b, flow)
    assert wk.flow_warp.launches == n + 1
    _bits(out_a, plain.flow_warp(a, flow))
    _bits(out_b, plain.flow_warp(b, flow))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warps_of_misaligned_tensors(dev, dtype):
    """A data pointer one element past alignment takes the scalar path of
    flow_warp and the per-channel loads of grouped_warp."""
    x = _misaligned(_uniform((1, 17, 40, 48), 7, -1, 1, dev, dtype))
    assert x.data_ptr() % 16
    flow = _flow(x.shape, 8, 20, dev)
    _bits(wk.flow_warp(x, flow), plain.flow_warp(x, flow))
    out_a, out_b = wk.flow_warp_pair(x[..., :3].contiguous(), x, flow)
    _bits(out_a, plain.flow_warp(x[..., :3], flow))
    _bits(out_b, plain.flow_warp(x, flow))
    fx, fy = (_uniform((1, 17, 40, 32), s, -12, 12, dev) for s in (9, 10))
    m = _uniform((1, 17, 40, 32), 11, 0, 1, dev)
    _bits(wk.grouped_warp(x, fx, fy, m, 16),
          plain.grouped_warp_plain(x, fx, fy, m, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0.4, 12.0, 50.0, 300.0])
def test_grouped_warp_equals_plain(dev, dtype, off):
    """OffsetDiversity's shape (48 channels, 32 units, 16 groups): batch 2,
    a row length that is no multiple of the tile, offsets to 300 px past
    the borders and NaN offsets.  One launch a call."""
    xg = _uniform((2, 21, 37, 48), 3, -1, 1, dev, dtype)
    fx, fy = (_uniform((2, 21, 37, 32), s, -off, off, dev) for s in (4, 5))
    fx[1, 2, 3, 7] = float("nan")
    fy[0, 20, 36, 30] = float("nan")
    m = _uniform((2, 21, 37, 32), 6, 0, 1, dev)
    n = wk.grouped_warp.launches
    out = wk.grouped_warp(xg, fx, fy, m, 16)
    assert wk.grouped_warp.launches == n + 1
    _bits(out, plain.grouped_warp_plain(xg, fx, fy, m, 16))


@pytest.mark.parametrize("c_src,go,gn", [(8, 8, 4), (48, 16, 16),
                                         (6, 12, 3)])
def test_grouped_warp_other_shapes(dev, c_src, go, gn):
    """Shapes other than the model's take the kernel's runtime constants."""
    x = _uniform((2, 13, 29, c_src), 12, -1, 1, dev)
    fx, fy = (_uniform((2, 13, 29, go), s, -9, 9, dev) for s in (13, 14))
    m = _uniform((2, 13, 29, go), 15, 0, 1, dev)
    _bits(wk.grouped_warp(x, fx, fy, m, gn),
          plain.grouped_warp_plain(x, fx, fy, m, gn))


def test_frame_launches_each_kernel(dev):
    """One two-layer P-frame launches flow_warp 14 times and grouped_warp
    once, and agrees with the same weights on the CPU."""
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    args = [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]
    outs = []
    for device in ("cpu", dev):
        model = LSSVC(params, device=device, od_offset_cap=10.0)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        counts = (wk.flow_warp.launches, wk.grouped_warp.launches)
        outs.append(model.forward_one_frame(*(a.to(device) for a in args)))
        delta = (wk.flow_warp.launches - counts[0],
                 wk.grouped_warp.launches - counts[1])
        assert delta == ((14, 1) if device == dev else (0, 0))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        assert abs(float(card[k]) - float(cpu[k])) <= 3e-3 * abs(float(cpu[k]))


def _rel_rms(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b ** 2)).clamp_min(1e-12))


def test_iframe_card_agrees_with_cpu(dev):
    """One IntraSS frame (EL 128x128 / BL 64x64) from the same weights on
    both devices: bits within 3e-3 relative, reconstructions within 5%
    relative RMS.  The I-frame pair launches no warp kernel."""
    params = init_intra_ss(torch.Generator().manual_seed(0), 192)
    rng = np.random.default_rng(8)
    x_bl = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    x_el = torch.from_numpy(rng.random((1, 128, 128, 3), np.float32))
    outs = []
    for device in ("cpu", dev):
        model = IntraSS(params, device=device)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        counts = (wk.flow_warp.launches, wk.grouped_warp.launches)
        outs.append(model.forward(x_bl.to(device), x_el.to(device)))
        assert counts == (wk.flow_warp.launches, wk.grouped_warp.launches)
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        assert abs(float(card[k]) - float(cpu[k])) <= 3e-3 * abs(float(cpu[k]))
    for k in ("x_hat_bl", "x_hat_el"):
        assert _rel_rms(card[k], cpu[k]) <= 0.05


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 4, 5, 3), device=dev, dtype=torch.float64)
    flow = torch.zeros((1, 4, 5, 2), device=dev)
    with pytest.raises(TypeError):
        wk.flow_warp(x, flow)
    with pytest.raises(ValueError):
        wk.flow_warp(x.float(), flow[..., :1])
    with pytest.raises(ValueError):
        wk.flow_warp(x.float(), flow.cpu())


def _chain_specs(seed, c, c_in=None):
    """A mixed chain with a nonzero bias on every conv: save, conv3, a conv1
    branch, dw3, act, conv3, add_saved(tag), add_saved."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=g) * 0.2

    head = [] if c_in is None else [
        {"kind": "conv3", "w": w(c, c_in, 3, 3), "b": w(c), "slope": 0.1}]
    return head + [
        {"kind": "save"},
        {"kind": "conv3", "w": w(c, c, 3, 3), "b": w(c), "slope": 0.1},
        {"kind": "conv1", "w": w(c, c, 1, 1), "b": w(c), "branch": "a"},
        {"kind": "dw3", "w": w(c, 1, 3, 3), "b": w(c), "slope": 0.01},
        {"kind": "act", "slope": 0.2},
        {"kind": "conv3", "w": w(c, c, 3, 3), "b": w(c)},
        {"kind": "add_saved", "tag": "a"},
        {"kind": "add_saved"},
    ]


def _check_chain(out, ref, dtype):
    """f32: max |err| <= 1e-5 max|ref|.  The kernel's products are three
    TF32 products of split operands (about 2^-21 relative each), summed in
    the tensor cores' order with an f32 total every tap, where F.conv2d
    sums in full f32 in another order.  bf16: relative RMS <= 1e-3 and max
    |err| <= 2^-5 max|ref|: the products are exact, but the sums run in
    another order and the tensor cores' accumulation truncates, so a
    rounding to bf16 can land the other way and carry through later
    layers."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    o, r = out.double(), ref.double()
    err, top = float((o - r).abs().max()), float(r.abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * top
    else:
        rms = float(torch.sqrt(((o - r) ** 2).mean() / (r ** 2).mean()))
        assert rms <= 1e-3 and err <= 2.0 ** -5 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c_in", [((1, 21, 37, 16), None),
                                        ((2, 30, 45, 3), 3),
                                        ((1, 19, 40, 128), None)])
def test_conv_chain_kernel_matches_plain(dev, dtype, shape, c_in):
    """One launch per image, within _check_chain's tolerances.  The
    3-channel head conv pads K to 16; the 128-channel f32 chain keeps its
    slots in global memory."""
    torch.backends.cudnn.allow_tf32 = False
    specs = _chain_specs(shape[0] + shape[-1], 16 if c_in else shape[-1],
                         c_in)
    x = _uniform(shape, 8, -1, 1, dev, dtype)
    chain = cc.ConvChain(specs, shape[-1], dtype, dev)
    n = cc.conv_chain.launches
    out = chain(x)
    assert cc.conv_chain.launches == n + shape[0]
    _check_chain(out, cc.conv_chain_plain(x, specs, dtype), dtype)
    if shape[0] == 2:  # a batch equals its images one by one
        assert torch.equal(out[1:], chain(x[1:]))


def test_conv_chain_plain_ignores_global_tf32(dev):
    """conv_chain_plain stays the f32 yardstick with TF32 left on
    globally: its convolutions turn TF32 off themselves."""
    specs = _chain_specs(5, 48)
    x = _uniform((1, 40, 72, 48), 9, -1, 1, dev)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        ref = cc.conv_chain_plain(x, specs, torch.float32)
        assert torch.backends.cudnn.allow_tf32
        out = cc.ConvChain(specs, 48, torch.float32, dev)(x)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    _check_chain(out, ref, torch.float32)


def test_conv_chain_rejects_what_the_kernel_does_not_take(dev):
    specs = _chain_specs(0, 4)
    chain = cc.ConvChain(specs, 4, torch.float32, dev)
    with pytest.raises(ValueError):
        chain(torch.zeros((1, 5, 6, 3), device=dev))
    with pytest.raises(ValueError):
        cc.ConvChain(specs * 10, 4, torch.float32, dev)  # past 64 layers


def _equal(a, b, what):
    assert a.shape == b.shape and torch.equal(a, b), what


def test_stream_closed_loop_of_each_model(dev, tmp_path):
    """On the card, each model's stream encoder returns its decoder's
    pictures bit for bit: IntraNoAR at 64x64, IntraSS at EL 128x128 / BL
    64x64, DMC at 64x64 and LSSVC at EL 128x128 / BL 64x64 (through the
    warp kernels)."""
    rng = np.random.default_rng(9)

    def a(*shape):
        return torch.from_numpy(rng.random((1, *shape), np.float32)).to(dev)

    intra = IntraSS(init_intra_ss(torch.Generator().manual_seed(1), 192),
                    device=dev)
    intra.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    intra.update()
    x_bl, x_el = a(64, 64, 3), a(128, 128, 3)
    bl = intra.base_layer_model
    enc = bl.compress(x_bl, with_recon=True)
    dec = bl.decompress(enc["strings"], enc["shape"])
    for k in ("x_hat", "y_hat"):
        _equal(enc[k], dec[k], f"IntraNoAR {k}")
    paths = [tmp_path / "bl.bin", tmp_path / "el.bin"]
    enc = compress_stream(intra, x_bl, x_el, *paths, 64, 64, 128, 128)
    dec = decompress_stream(intra, *paths)
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        _equal(enc[k], dec[k], f"IntraSS {k}")

    video = LSSVCExtend(init_lssvc(torch.Generator().manual_seed(2)),
                        device=dev, od_offset_cap=10.0)
    video.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    video.update()
    dpb = {"ref_frame_bl": a(64, 64, 3), "ref_feature_bl": a(64, 64, 64),
           "ref_frame_el": a(128, 128, 3), "ref_feature_el": a(128, 128, 48)}
    counts = (wk.flow_warp.launches, wk.grouped_warp.launches)
    enc_bl = video.base_layer_model.compress(x_bl, dpb)
    dec_bl = video.base_layer_model.decompress(enc_bl["string"], 64, 64, dpb)
    for k in ("ref_frame_bl", "ref_feature_bl", "y_hat_bl", "mv_hat_bl"):
        _equal(enc_bl["dpb"][k], dec_bl["dpb"][k], f"DMC {k}")
    dpb_el = dict(dpb, texture=dec_bl["dpb"]["ref_feature_bl"],
                  y_hat_bl=dec_bl["dpb"]["y_hat_bl"],
                  mv_hat_bl=dec_bl["dpb"]["mv_hat_bl"])
    enc_el = video.compress(x_el, dpb_el)
    dec_el = video.decompress(enc_el["string"], 128, 128, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        _equal(enc_el["dpb"][k], dec_el["dpb"][k], f"LSSVC {k}")
    # each layer's encoder and decoder run SpyNet's 4 and the 3 context
    # warps (the decoders only the 3), the EL's OffsetDiversity one each
    assert (wk.flow_warp.launches - counts[0],
            wk.grouped_warp.launches - counts[1]) == (20, 2)


def test_card_stream_decodes_in_a_fresh_process(dev, tmp_path, monkeypatch):
    """The CLI writes a 120x104 3-frame GOP's streams on the card; the
    decode CLI, in a fresh process on the card, rebuilds the run's EL and
    BL pictures byte for byte."""
    h, w, frames = 104, 120, 3
    cfg = write_dataset(tmp_path / "ds", h, w, frames=frames, gop=3, seed=5)
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    torch.save(init_lssvc(torch.Generator().manual_seed(2)), video)
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = runner.HostCopy

    def recording(tensors):
        for k in pictures:
            pictures[k].append(tensors[k].clone())
        return real_copy(tensors)

    monkeypatch.setattr(runner, "HostCopy", recording)
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", str(intra),
              "--model_path", str(video), "--output_path",
              str(tmp_path / "out"), "--ratios", "x2", "--write_stream", "1",
              "--stream_path", str(tmp_path / "bins")])
    dec = subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(tmp_path / "bins" / "seq1" / "0" / "x2"), "--i_frame_model_path",
         str(intra), "--model_path", str(video), "--height", str(h),
         "--width", str(w), "--ratio", "x2", "--gop", "3", "--frame_num",
         str(frames), "--yuv_out", str(tmp_path / "el.yuv"), "--yuv_out_bl",
         str(tmp_path / "bl.yuv")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert dec.returncode == 0, dec.stderr
    for layer in ("el", "bl"):
        want = b"".join(yuv_frame(x, (0, 0, 0, 0))
                        for x in pictures[f"x_hat_{layer}"])
        assert (tmp_path / f"{layer}.yuv").read_bytes() == want, layer


# (ca, cb, (n, h, w)) of the packed pair's cases, also held on the CPU to
# the JAX package (tests/test_torch_packed.py): the model's 3 + 48, a row of
# whole 16-byte chunks (4 + 60; 8 + 120 puts both sources on the vector
# path in both dtypes), one that is not (3 + 5), batch 2 and a width that
# is no multiple of the 64-pixel tile (70: every row's span but the first
# starts off a 16-byte boundary), and two whole tiles a row
PACKED_PAIR_CASES = [
    pytest.param(3, 48, (2, 21, 70), id="3-48"),
    pytest.param(3, 5, (2, 21, 70), id="3-5"),
    pytest.param(4, 60, (2, 21, 70), id="4-60"),
    pytest.param(8, 120, (2, 21, 70), id="8-120"),
    pytest.param(3, 48, (1, 21, 128), id="3-48-w128"),
]


def _packed_pair_call(a, b, flow, out):
    """The packed pair's C entry point into `out` (N, H, W, ca+cb), which
    the wrapper, allocating its own output, cannot reach."""
    n, h, w, ca = a.shape
    err = wk._lib().lssvc_flow_warp_pair_packed(
        a.data_ptr(), b.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w,
        ca, b.shape[-1], wk._DTYPES[a.dtype],
        torch.cuda.current_stream().cuda_stream)
    assert err == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ca,cb,nhw", PACKED_PAIR_CASES)
def test_pair_packed_store_equals_plain(dev, dtype, ca, cb, nhw):
    """The fused packed pair warp: both sources into one (N, H, W, ca+cb)
    buffer in one launch, viewed width-packed; bit for bit the plain warp
    of their concat, packed, with flows past the borders and a NaN flow; a
    launch counts on `launches` and `packed_launches`."""
    a = _uniform(nhw + (ca,), 1, -1, 1, dev, dtype)
    b = _uniform(nhw + (cb,), 2, -1, 1, dev, dtype)
    flow = _flow(a.shape, 3, 40, dev)
    n, p = wk.flow_warp.launches, wk.flow_warp.packed_launches
    out = wk.flow_warp_pair(a, b, flow, packed_out=True)
    assert (wk.flow_warp.launches, wk.flow_warp.packed_launches) == \
        (n + 1, p + 1)
    assert out.shape == (nhw[0], nhw[1], nhw[2] // 2, 2 * (ca + cb))
    _bits(out, plain.flow_warp(torch.cat([a, b], -1), flow)
          .reshape(out.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ca,cb", [(3, 48), (8, 120)])
def test_pair_packed_store_of_misaligned_tensors(dev, dtype, ca, cb):
    """Sources one element past 16-byte alignment take the scalar loads;
    an output one element past it (through the C entry point) starts every
    span off a 16-byte boundary, for aligned and misaligned sources: all
    bit for bit the plain warp of the concat."""
    shape = (2, 21, 70)
    a = _uniform(shape + (ca,), 4, -1, 1, dev, dtype)
    b = _uniform(shape + (cb,), 5, -1, 1, dev, dtype)
    flow = _flow(a.shape, 6, 40, dev)
    ref = plain.flow_warp(torch.cat([a, b], -1), flow)
    a_m, b_m = _misaligned(a), _misaligned(b)
    assert a_m.data_ptr() % 16 and b_m.data_ptr() % 16
    n = wk.flow_warp.launches
    out = wk.flow_warp_pair(a_m, b_m, flow, packed_out=True)
    assert wk.flow_warp.launches == n + 1
    _bits(out, ref.reshape(out.shape))
    for srcs in ((a, b), (a_m, b_m)):
        out = _misaligned(torch.zeros_like(ref))
        assert out.data_ptr() % 16
        _packed_pair_call(*srcs, flow, out)
        _bits(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_packed_store_equals_plain(dev, dtype):
    """The grouped warp's packed store is its output viewed packed: bit for
    bit the plain version, packed; odd widths raise."""
    x = _uniform((1, 40, 96, 48), 4, -1, 1, dev, dtype)
    fx, fy = (_uniform((1, 40, 96, 32), s, -12, 12, dev) for s in (5, 6))
    m = _uniform((1, 40, 96, 32), 7, 0, 1, dev)
    n, p = wk.grouped_warp.launches, wk.grouped_warp.packed_launches
    out = wk.grouped_warp(x, fx, fy, m, 16, packed_out=True)
    assert (wk.grouped_warp.launches, wk.grouped_warp.packed_launches) == \
        (n + 1, p + 1)
    _bits(out, plain.grouped_warp_plain(x, fx, fy, m, 16).reshape(out.shape))
    with pytest.raises(ValueError, match="even width"):
        wk.grouped_warp(x[:, :, :95], fx[:, :, :95], fy[:, :, :95],
                        m[:, :, :95], 16, packed_out=True)


@pytest.mark.parametrize("precision", ["bf16", "high"])
def test_precision_frames_card_agree_with_cpu(dev, precision):
    """A bf16 or high two-layer P-frame (EL 128x128 / BL 64x64) on the card
    against the same frame on the CPU in the same precision, with the CPU
    tests' tolerances (tests/test_torch_precision.py): bits within 2%, the
    reconstructions within 5% relative RMS.  (On the CPU `high` is plain
    f32, so the card's TF32 frame is held to the fp32 frame.)"""
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    args = [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]
    outs = []
    for device in ("cpu", dev):
        model = LSSVC(params, device=device, od_offset_cap=10.0,
                      precision=precision)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        outs.append(model.forward_one_frame(*(a.to(device) for a in args)))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        assert abs(float(card[k]) - float(cpu[k])) <= 0.02 * abs(float(cpu[k]))
    for k in ("ref_frame_bl", "ref_frame_el"):
        assert card["dpb"][k].dtype == cpu["dpb"][k].dtype
        assert _rel_rms(card["dpb"][k], cpu["dpb"][k]) <= 0.05


# ---------------------------------------------------------------------------
# int8_conv (csrc/int8_conv.cu): the s8 convolution of the int8 precision

# (input (n, h, w, cin), OIHW kernel (cout, kh, kw), stride, padding) at the
# int8 path's kinds of site: packed 3x3 and 1x1 stacks (96, 128), the
# 102-channel feature_conv.0, stride 2 with the packed (1, 0) padding,
# SpyNet's packed 7x3 kernels (Cin 32 -> 128, 128 -> 256, Cout 8), batch 2
INT8_CASES = [
    ((1, 19, 37, 96), (96, 3, 3), 1, ((1, 1), (1, 1))),
    ((1, 19, 37, 96), (64, 1, 1), 1, ((0, 0), (0, 0))),
    ((1, 17, 33, 128), (128, 3, 3), 1, ((1, 1), (1, 1))),
    ((1, 21, 35, 102), (96, 3, 3), 1, ((1, 1), (1, 1))),
    ((1, 21, 35, 102), (96, 3, 3), 2, ((1, 1), (1, 0))),
    ((1, 23, 29, 32), (128, 7, 3), 1, ((3, 3), (1, 1))),
    ((1, 23, 29, 128), (256, 7, 3), 1, ((3, 3), (1, 0))),
    ((1, 23, 29, 64), (8, 7, 3), 1, ((3, 3), (1, 1))),
    ((2, 12, 40, 96), (96, 3, 3), 1, ((1, 1), (1, 1))),
]


def _int8_inputs(xs, ws, seed, dev):
    rng = np.random.default_rng(seed)
    cout, kh, kw = ws
    w = torch.from_numpy(rng.integers(-127, 128, (cout, xs[3], kh, kw))
                         .astype(np.int8)).to(dev)
    x = torch.from_numpy(rng.normal(0, 2, xs).astype(np.float32)).to(dev)
    mult = torch.from_numpy(rng.uniform(1e-6, 1e-4, cout)
                            .astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)) \
        .to(dev)
    return x, w, mult, bias


@pytest.mark.parametrize("in_dtype", [torch.int8, torch.bfloat16,
                                      torch.float32])
@pytest.mark.parametrize("xs,ws,stride,pad", INT8_CASES)
def test_int8_conv_equals_plain(dev, in_dtype, xs, ws, stride, pad):
    """Bit for bit: the s32 accumulator is exact integer arithmetic; the
    quantizer on load is an IEEE division and rint as the plain
    `quant_act`; the bf16 epilogue is a separate multiply and add rounded
    once.  One launch a call."""
    x, w, mult, bias = _int8_inputs(xs, ws, sum(xs) + ws[0], dev)
    s_in = 0.0173
    if in_dtype == torch.int8:
        x, s_in = q8.quant_act(x, s_in), None
    else:
        x = x.to(in_dtype)
    n = q8.int8_conv2d.launches
    acc = q8.int8_conv2d(x, w, stride, pad, s_in=s_in)
    y = q8.int8_conv2d(x, w, stride, pad, s_in=s_in, mult=mult, bias=bias)
    assert q8.int8_conv2d.launches == n + 2
    assert acc.dtype == torch.int32 and y.dtype == torch.bfloat16
    _bits(acc, q8.int8_conv2d_plain(x, w, stride, pad, s_in=s_in))
    _bits(y, q8.int8_conv2d_plain(x, w, stride, pad, s_in=s_in, mult=mult,
                                  bias=bias))


# Cases that reach each branch of the kernel's plan (csrc/int8_conv.cu
# `make_plan`), each with the path its plan must take on an H100 (132 SMs):
# (input, OIHW kernel (cout, kh, kw), stride, padding, input dtype, path).
# A path names the weights' mode (`resident`, or a ring of 2 or 3 stages:
# `ring2`, `ring3`), the halo's (`staged`, or `direct` loads), and where it
# is the case's point: `half` (half of the M tiles busy), `linear` (a 1x1
# as one GEMM over the batch's pixels), `under` (fewer tiles than SMs: a
# block a tile), `over` (more tiles than the grid and no multiple of it:
# blocks take one or two, the prefetch and the ring run across tiles),
# `elements` (element loads of an input whose rows are no whole 16-byte
# units).  Cout 384 and 512 run 3 and 4 chunks over one quantized halo, as
# SpyNet's 128 -> 256 runs 2 with its weights in a ring; Cout 4, 6 and 8,
# Cin 32 (f32), 106 and 512, stride 2, and the 72x30 SpyNet level.
INT8_PATHS = [
    ((1, 64, 96, 96), (96, 3, 3), 1, ((1, 1), (1, 1)), torch.bfloat16,
     "resident staged half under"),
    ((2, 12, 40, 96), (96, 1, 1), 1, ((0, 0), (0, 0)), torch.bfloat16,
     "resident staged linear under"),
    ((1, 48, 64, 128), (256, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring3 staged under"),
    ((1, 72, 30, 128), (256, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring3 staged under"),
    ((1, 288, 120, 128), (256, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring2 staged over"),
    ((1, 40, 50, 256), (128, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring2 staged under"),
    ((1, 24, 40, 512), (128, 1, 1), 1, ((0, 0), (0, 0)), torch.bfloat16,
     "resident direct linear"),
    ((1, 24, 40, 96), (384, 1, 1), 1, ((0, 0), (0, 0)), torch.bfloat16,
     "resident staged linear"),
    ((1, 24, 40, 128), (512, 1, 1), 1, ((0, 0), (0, 0)), torch.int8,
     "resident staged linear"),
    ((1, 30, 44, 128), (4, 3, 3), 1, ((1, 1), (1, 1)), torch.bfloat16,
     "resident staged"),
    ((1, 30, 44, 96), (6, 3, 3), 1, ((1, 1), (1, 1)), torch.bfloat16,
     "resident staged"),
    ((1, 30, 44, 64), (8, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "resident staged"),
    ((1, 30, 44, 32), (128, 7, 3), 1, ((3, 3), (1, 1)), torch.float32,
     "resident staged"),
    ((1, 65, 98, 106), (128, 3, 3), 2, ((1, 1), (1, 0)), torch.bfloat16,
     "resident direct elements"),
    ((1, 64, 96, 96), (96, 3, 3), 2, ((1, 1), (1, 0)), torch.bfloat16,
     "ring2 staged"),
    ((1, 272, 150, 96), (96, 3, 3), 1, ((1, 1), (1, 1)), torch.bfloat16,
     "resident staged over"),
    ((1, 40, 60, 192), (96, 3, 3), 1, ((1, 1), (1, 1)), torch.float32,
     "ring3 staged"),
    ((1, 288, 120, 256), (128, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring3 direct over"),
    ((1, 288, 120, 128), (64, 7, 3), 1, ((3, 3), (1, 1)), torch.bfloat16,
     "ring2 direct under"),
]


def _plan_path(plan, cout, kh, kw):
    """The words of `INT8_PATHS` that a plan (`int8_conv_plan`) takes."""
    words = {f"ring{plan['stages']}" if plan["ring"] else "resident",
             "staged" if plan["staging"] else "direct"}
    n = q8.chunk_n(cout)
    if plan["mtiles"] < 4 * (2 if n <= 64 else 1):
        words.add("half")
    if (kh, kw) == (1, 1) and plan["th"] == 1:
        words.add("linear")
    if plan["grid"] == plan["tiles"]:
        words.add("under")
    elif plan["tiles"] % plan["grid"]:
        words.add("over")
    if not plan["vec_in"]:
        words.add("elements")
    return words


@pytest.mark.parametrize("xs,ws,stride,pad,in_dtype,path", INT8_PATHS)
def test_int8_conv_plan_paths_equal_plain(dev, xs, ws, stride, pad,
                                          in_dtype, path):
    """The kernel's plan takes the case's path; bit for bit against the
    plain version there, s32 and the bf16 epilogue; one launch a call."""
    x, w, mult, bias = _int8_inputs(xs, ws, sum(xs) + ws[0] + stride, dev)
    s_in = 0.0173
    if in_dtype == torch.int8:
        x, s_in = q8.quant_act(x, s_in), None
    else:
        x = x.to(in_dtype)
    for m, b in ((None, None), (mult, bias)):
        plan = q8.int8_conv_plan(x, w, stride, pad, s_in=s_in, mult=m,
                                 bias=b)
        assert set(path.split()) <= _plan_path(plan, *ws), plan
    n = q8.int8_conv2d.launches
    acc = q8.int8_conv2d(x, w, stride, pad, s_in=s_in)
    y = q8.int8_conv2d(x, w, stride, pad, s_in=s_in, mult=mult, bias=bias)
    assert q8.int8_conv2d.launches == n + 2
    _bits(acc, q8.int8_conv2d_plain(x, w, stride, pad, s_in=s_in))
    _bits(y, q8.int8_conv2d_plain(x, w, stride, pad, s_in=s_in, mult=mult,
                                  bias=bias))


@pytest.mark.parametrize("in_dtype,s_in", [(torch.float32, 0.0173),
                                           (torch.bfloat16, 2.0 ** -6)])
def test_int8_conv_quantizes_ties_as_the_plain_version(dev, in_dtype, s_in):
    """Inputs at and next to v / s = k + 1/2 (and +-inf): the kernel's
    quantizer multiplies by 1/s and divides where the product lies near a
    half-integer; its s8 values equal `quant_act`'s (a 1x1 identity conv
    reads them back through the s32 accumulator).  In bf16 the scale is a
    power of two, so that the ties survive bf16's rounding."""
    rng = np.random.default_rng(9)
    k = rng.integers(-140, 140, (1, 40, 64, 32)).astype(np.float32)
    nudge = rng.choice([-2, -1, 0, 1, 2], k.shape).astype(np.float32)
    v = (k + 0.5) * np.float32(s_in)
    v = np.nextafter(v, np.where(nudge > 0, np.inf, np.where(
        nudge < 0, -np.inf, v)), dtype=np.float32)
    v = np.where(nudge == 2, (k + 0.5) * np.float32(s_in) * 1.00001, v)
    v.reshape(-1)[:4] = [np.inf, -np.inf, 0.5 * s_in, -0.5 * s_in]
    x = torch.from_numpy(v.astype(np.float32)).to(dev, in_dtype)
    w = torch.eye(32, dtype=torch.int8, device=dev).view(32, 32, 1, 1)
    acc = q8.int8_conv2d(x, w, 1, 0, s_in=s_in)
    _bits(acc, q8.quant_act(x, s_in).to(torch.int32))
    _bits(acc, q8.int8_conv2d_plain(x, w, 1, 0, s_in=s_in))


@pytest.mark.parametrize("sign", [1, -1])
def test_int8_conv_full_scale_at_the_largest_k(dev, sign):
    """All inputs 127 and all weights +-127 at K = 7*3*256 = 5376: the
    interior accumulator is 127^2 * 5376 = 86,709,504 (s32, exact)."""
    x = torch.full((1, 16, 20, 256), 127, dtype=torch.int8, device=dev)
    w = torch.full((64, 256, 7, 3), sign * 127, dtype=torch.int8,
                   device=dev)
    acc = q8.int8_conv2d(x, w, 1, ((3, 3), (1, 1)))
    _bits(acc, q8.int8_conv2d_plain(x, w, 1, ((3, 3), (1, 1))))
    assert int(acc[0, 8, 10, 0]) == sign * 127 * 127 * 5376


def test_int8_conv_of_misaligned_tensors(dev):
    """An input one element past 16-byte alignment takes the kernel's
    element loads; an output one element past alignment (through the C
    entry point: the wrapper allocates its own) its element stores."""
    x, w, mult, bias = _int8_inputs((1, 19, 37, 96), (96, 3, 3), 5, dev)
    xb = _misaligned(x.to(torch.bfloat16))
    pad = ((1, 1), (1, 1))
    ref = q8.int8_conv2d_plain(xb, w, 1, pad, s_in=0.02, mult=mult,
                               bias=bias)
    _bits(q8.int8_conv2d(xb, w, 1, pad, s_in=0.02, mult=mult, bias=bias),
          ref)
    kern = q8.Int8Weight(w, mult, bias)
    lay = kern.layout()
    for out_bf16, dtype in ((1, torch.bfloat16), (0, torch.int32)):
        buf = torch.empty(ref.numel() + 1, dtype=dtype, device=dev)
        out = buf[1:].view(ref.shape)
        err = q8._lib().lssvc_int8_conv(
            xb.data_ptr(), lay.data_ptr(), out.data_ptr(), mult.data_ptr(),
            bias.data_ptr(), float(np.float32(0.02)), 1, 19, 37, 96, 19, 37,
            96, kern.cout_pad, kern.cinp, 3, 3, 1, 1, 1, 1, out_bf16,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0
        want = ref if out_bf16 else q8.int8_conv2d_plain(xb, w, 1, pad,
                                                         s_in=0.02)
        _bits(out, want)


def test_int8_conv_rejects_what_the_kernel_does_not_take(dev):
    w = torch.zeros((8, 16, 3, 3), dtype=torch.int8, device=dev)
    x = torch.zeros((1, 5, 6, 16), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        q8.int8_conv2d(x.float(), w)  # a float input needs s_in
    with pytest.raises(ValueError):
        q8.int8_conv2d(x[..., :8], w)
    with pytest.raises(ValueError):
        q8.int8_conv2d(x, w.cpu())
    with pytest.raises(ValueError):
        q8.int8_conv2d(x, w, stride=(1, 2))


def test_matmuls_do_not_read_the_tf32_flags(dev):
    """`matmul_f32out` (bf16 operands, f32 product) and `matmul_highest`
    (full f32) give the same bits whatever the process-wide TF32 flag
    (which another thread's scope may hold), and neither changes it."""
    from lssvc_tpu_torch.ops.nn import (Mode, matmul_f32out,
                                        matmul_highest, precision_scope)

    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((2, 33, 40, 96), generator=gen, device=dev)
    b = torch.randn((96, 48), generator=gen, device=dev)
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    outs = {}
    try:
        for flag in (False, True):
            matmul.allow_tf32 = flag
            with precision_scope(Mode("bf16")):
                matmul.allow_tf32 = flag  # as another thread's scope may
                outs[flag] = (matmul_f32out(a, b), matmul_highest(a, b))
                assert matmul.allow_tf32 == flag
    finally:
        matmul.allow_tf32 = was
    for x, y in zip(outs[False], outs[True]):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    exact = a.double() @ b.double()
    bf = a.bfloat16().double() @ b.bfloat16().double()
    assert float((outs[False][0].double() - bf).abs().max()) <= 1e-4 * float(
        bf.abs().max())
    assert float((outs[False][1].double() - exact).abs().max()) <= 1e-6 * float(
        exact.abs().max())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_rdo_stream_on_the_card(dev, tmp_path, precision):
    """Latent RDO on the card (IntraNoAR N=192, 64x64, 4 iterations): the
    loss never rises above its start; the refined latents' closed loop
    holds (the encoder's pictures are the decoder's, bit for bit); in
    fp32 the bins also decode to the estimated path's reconstruction (in
    bf16 the estimated path rounds y - means in bf16 and the coder in
    f32, as in the JAX package, so the two differ)."""
    from lssvc_tpu_torch.models import IntraNoAR
    from lssvc_tpu_torch.models.init import init_intra_noar

    model = IntraNoAR(init_intra_noar(torch.Generator().manual_seed(0), 192),
                      device=dev, precision=precision)
    model.update()
    x = _uniform((1, 64, 64, 3), 4, 0, 1, dev)
    trace = []
    y, z = model.refined_y_z(x, {"max_iter": 4, "trace": trace})
    assert len(trace) == 4 and min(t[0] for t in trace) <= trace[0][0]
    enc = model.compress(y=y, z=z, with_recon=True)
    dec = model.decompress(enc["strings"], enc["shape"])
    for k in ("x_hat", "y_hat"):
        _equal(enc[k], dec[k], f"RDO {precision} closed loop {k}")
    if precision == "fp32":
        est = model.encode_decode(x, rdo=True, rdo_opt={"max_iter": 4})
        res = model.encode_decode(x, tmp_path / "rdo.bin", 64, 64, rdo=True,
                                  rdo_opt={"max_iter": 4})
        for k in ("x_hat", "y_hat"):
            _equal(res[k], est[k], f"RDO estimated path {k}")
            _equal(res[k], dec[k], f"RDO decode {k}")


def test_cheng2020_stream_round_trips_on_the_card(dev):
    """Cheng2020Anchor (N=192) on the card: the decoder's y_hat equals the
    encoder's, and the decoded picture is the forward's g_s of it."""
    from lssvc_tpu_torch.models import Cheng2020Anchor
    from lssvc_tpu_torch.models.init import init_cheng2020

    model = Cheng2020Anchor(init_cheng2020(torch.Generator().manual_seed(3),
                                           192), device=dev)
    model.update()
    x = _uniform((1, 64, 64, 3), 5, 0, 1, dev)
    enc = model.compress(x=x)
    dec = model.decompress(enc["strings"], enc["shape"])
    assert np.array_equal(dec["y_hat"].cpu().numpy(), enc["y_hat"])
    assert dec["x_hat"].shape == (1, 64, 64, 3)
    assert bool(torch.isfinite(model.forward(x)["bit"]))


# ---------------------------------------------------------------------------
# Training: the warps' backward kernels (csrc/warp_grad.cu)

def _grad_tol(got, ref, dtype):
    """f32: max |err| <= 1e-5 max|ref| (the source gradient sums with
    atomics in another order); bf16: relative RMS <= 1e-2."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    if dtype == torch.float32:
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    else:
        rms = float((g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
        assert rms <= 1e-2, rms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", [False, True])
def test_flow_warp_backward_kernel(dev, dtype, pair):
    """flow_warp / flow_warp_pair under autograd: a grad_fn, one backward
    launch, the plain autograd's gradients; the flow's bit-equal across
    two launches."""
    n, h, w = 2, 37, 53
    a = _uniform((n, h, w, 3), 1, 0, 1, dev, dtype).requires_grad_()
    b = _uniform((n, h, w, 48), 2, 0, 1, dev, dtype).requires_grad_()
    flow = _uniform((n, h, w, 2), 3, -6, 6, dev).requires_grad_()
    g_a = _uniform((n, h, w, 3), 4, -1, 1, dev, dtype)
    g_b = _uniform((n, h, w, 48), 5, -1, 1, dev, dtype)
    wk.flow_warp_backward.launches = 0
    outs = wk.flow_warp_pair(a, b, flow) if pair else (wk.flow_warp(a, flow),)
    assert all(o.grad_fn is not None for o in outs)
    ins = [flow, a, b] if pair else [flow, a]
    got = torch.autograd.grad(outs, ins, [g_a, g_b][:len(outs)])
    assert wk.flow_warp_backward.launches == 1
    ref = wk.flow_warp_backward_plain(flow, a, g_a, b if pair else None,
                                      g_b if pair else None)
    for x, y in zip(got, ref):
        _grad_tol(x, y, dtype if x.dtype == dtype else torch.float32)
    again = torch.autograd.grad(
        wk.flow_warp_pair(a, b, flow) if pair else (wk.flow_warp(a, flow),),
        ins, [g_a, g_b][:len(outs)])
    _bits(again[0], got[0])


def test_flow_warp_backward_skips_what_needs_no_gradient(dev):
    """SpyNet's warp of an input frame: only the flow takes a gradient."""
    x = _uniform((1, 16, 24, 3), 6, 0, 1, dev)
    flow = _uniform((1, 16, 24, 2), 7, -3, 3, dev).requires_grad_()
    out = wk.flow_warp(x, flow)
    (gf,) = torch.autograd.grad(out, flow, torch.ones_like(out))
    ref = wk.flow_warp_backward_plain(flow, x, torch.ones_like(out))[0]
    _grad_tol(gf, ref, torch.float32)
    gf2, gx, gb = wk.flow_warp_backward(flow, x, torch.ones_like(out),
                                        need_a=False)
    assert gx is None and gb is None
    _bits(gf2, gf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_warp_backward_kernel(dev, dtype):
    n, h, w, c_src, go, gn = 2, 21, 35, 48, 32, 16
    x = _uniform((n, h, w, c_src), 8, 0, 1, dev, dtype).requires_grad_()
    fx = _uniform((n, h, w, go), 9, -8, 8, dev).requires_grad_()
    fy = _uniform((n, h, w, go), 10, -8, 8, dev).requires_grad_()
    mask = _uniform((n, h, w, go), 11, 0, 1, dev).requires_grad_()
    g = _uniform((n, h, w, go * c_src // gn), 12, -1, 1, dev, dtype)
    wk.grouped_warp_backward.launches = 0
    out = wk.grouped_warp(x, fx, fy, mask, gn)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, [x, fx, fy, mask], g)
    assert wk.grouped_warp_backward.launches == 1
    ref = wk.grouped_warp_backward_plain(x, fx, fy, mask, gn, g)
    for a, b in zip(got, ref):
        _grad_tol(a, b, dtype if a.dtype == dtype else torch.float32)
    again = torch.autograd.grad(wk.grouped_warp(x, fx, fy, mask, gn),
                                [fx, fy, mask], g)
    for a, b in zip(again, got[1:]):
        _bits(a, b)


def _smooth(shape, seed, amp, dev, cell=16):
    """A field of amplitude amp that varies over `cell` pixels: a coarse
    uniform grid upsampled bilinearly (a codec's motion)."""
    n, h, w, c = shape
    coarse = _uniform((n, c, h // cell + 2, w // cell + 2), seed, -amp, amp,
                      dev)
    return torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()


def _path_flows(kind, shape, seed, dev):
    """Flows that send the kernels' tiles down each scatter path: "smooth"
    (2 px: every tile's box fits), "direct" (random, far past the
    borders: no box fits), "mixed" (the left half smooth, the right half
    direct, in one launch), "smooth40" (12 px plus 40 px smooth offsets
    per channel: the grouped warp's uncapped offsets)."""
    n, h, w, c = shape
    if kind == "smooth":
        return _smooth(shape, seed, 2.0, dev)
    far = _uniform(shape, seed, -3 * w, 3 * w, dev)
    if kind == "direct":
        return far
    if kind == "mixed":
        f = _smooth(shape, seed + 1, 2.0, dev)
        f[:, :, w // 2:] = far[:, :, w // 2:]
        return f
    return _smooth((n, h, w, 1), seed, 12.0, dev) + _smooth(shape, seed + 2,
                                                            40.0, dev)


def _rounded_once(got, ref32):
    """A bf16 source gradient is the f32 one rounded once: within half a
    bf16 ulp, plus 1e-5 max|ref| for the f32 sums' order."""
    g, r = got.float(), ref32
    slack = 2.0 ** -8 * r.abs() + 1e-5 * float(r.abs().max())
    assert bool(((g - r).abs() <= slack).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flows", ["smooth", "direct", "mixed"])
@pytest.mark.parametrize("hw", [(19, 37), (33, 65), (64, 64)])
def test_flow_warp_backward_scatter_paths(dev, dtype, flows, hw):
    """The pair's backward on tiles cut unevenly (19x37, 33x65) and whole
    (64x64, 8x32 tiles), batch 2 at 19x37, on each scatter path: the plain
    autograd's gradients, the flow's bit-equal across two launches, a bf16
    source's the f32 kernel's rounded once."""
    n = 2 if hw == (19, 37) else 1
    h, w = hw
    a = _uniform((n, h, w, 3), 21, 0, 1, dev, dtype)
    b = _uniform((n, h, w, 48), 22, 0, 1, dev, dtype)
    flow = _path_flows(flows, (n, h, w, 2), 23, dev)
    g_a = _uniform((n, h, w, 3), 24, -1, 1, dev, dtype)
    g_b = _uniform((n, h, w, 48), 25, -1, 1, dev, dtype)
    got = wk.flow_warp_backward(flow, a, g_a, b, g_b)
    ref = wk.flow_warp_backward_plain(flow, a, g_a, b, g_b)
    for x, y in zip(got, ref):
        _grad_tol(x, y, dtype if x.dtype == dtype else torch.float32)
    _bits(wk.flow_warp_backward(flow, a, g_a, b, g_b)[0], got[0])
    if dtype == torch.bfloat16:
        got32 = wk.flow_warp_backward(flow, a.float(), g_a.float(),
                                      b.float(), g_b.float())
        for x, y in zip(got[1:], got32[1:]):
            _rounded_once(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flows", ["smooth", "smooth40", "direct", "mixed"])
@pytest.mark.parametrize("hw", [(19, 37), (33, 65), (64, 64)])
def test_grouped_warp_backward_scatter_paths(dev, dtype, flows, hw):
    """The grouped warp's backward at the model's shape on tiles cut
    unevenly and whole (8x8 tiles), on each scatter path: the plain
    autograd's gradients, the flow and mask gradients bit-equal across two
    launches, x's the f32 kernel's rounded once in bf16."""
    n = 2 if hw == (19, 37) else 1
    h, w = hw
    go, gn = 32, 16
    x = _uniform((n, h, w, 48), 26, 0, 1, dev, dtype)
    fx = _path_flows(flows, (n, h, w, go), 27, dev)
    fy = _path_flows(flows, (n, h, w, go), 28, dev)
    m = _uniform((n, h, w, go), 29, 0, 1, dev)
    g = _uniform((n, h, w, 96), 30, -1, 1, dev, dtype)
    got = wk.grouped_warp_backward(x, fx, fy, m, gn, g)
    ref = wk.grouped_warp_backward_plain(x, fx, fy, m, gn, g)
    for a, b in zip(got, ref):
        _grad_tol(a, b, dtype if a.dtype == dtype else torch.float32)
    for a, b in zip(wk.grouped_warp_backward(x, fx, fy, m, gn, g)[1:],
                    got[1:]):
        _bits(a, b)
    if dtype == torch.bfloat16:
        got32 = wk.grouped_warp_backward(x.float(), fx, fy, m, gn,
                                         g.float())
        _rounded_once(got[0], got32[0])


@pytest.mark.parametrize("flows", ["smooth", "mixed"])
@pytest.mark.parametrize("c_src,go,gn", [(8, 8, 4), (48, 16, 16),
                                         (6, 12, 3), (12, 8, 4)])
def test_grouped_warp_backward_other_shapes(dev, flows, c_src, go, gn):
    """Shapes other than the model's take the kernel's runtime constants,
    on both scatter paths."""
    shape = (2, 13, 29)
    x = _uniform((*shape, c_src), 31, 0, 1, dev)
    fx = _path_flows(flows, (*shape, go), 32, dev)
    fy = _path_flows(flows, (*shape, go), 33, dev)
    m = _uniform((*shape, go), 34, 0, 1, dev)
    g = _uniform((*shape, go * c_src // gn), 35, -1, 1, dev)
    got = wk.grouped_warp_backward(x, fx, fy, m, gn, g)
    ref = wk.grouped_warp_backward_plain(x, fx, fy, m, gn, g)
    for a, b in zip(got, ref):
        _grad_tol(a, b, torch.float32)
    for a, b in zip(wk.grouped_warp_backward(x, fx, fy, m, gn, g)[1:],
                    got[1:]):
        _bits(a, b)


def test_warp_backward_misaligned_sources(dev):
    """Sources one element past alignment take the scalar lanes of
    flow_warp_backward and the runtime path of grouped_warp_backward."""
    n, h, w = 1, 21, 45
    a = _misaligned(_uniform((n, h, w, 48), 36, 0, 1, dev))
    assert a.data_ptr() % 16
    flow = _path_flows("mixed", (n, h, w, 2), 37, dev)
    g_a = _uniform((n, h, w, 48), 38, -1, 1, dev)
    got = wk.flow_warp_backward(flow, a, g_a)
    ref = wk.flow_warp_backward_plain(flow, a, g_a)
    for x, y in zip(got[:2], ref[:2]):
        _grad_tol(x, y, torch.float32)
    fx = _path_flows("smooth", (n, h, w, 32), 39, dev)
    fy = _path_flows("smooth", (n, h, w, 32), 40, dev)
    m = _uniform((n, h, w, 32), 41, 0, 1, dev)
    g = _uniform((n, h, w, 96), 42, -1, 1, dev)
    got = wk.grouped_warp_backward(a, fx, fy, m, 16, g)
    ref = wk.grouped_warp_backward_plain(a, fx, fy, m, 16, g)
    for x, y in zip(got, ref):
        _grad_tol(x, y, torch.float32)


def test_packed_warps_refuse_grad_on_the_card(dev):
    a = _uniform((1, 8, 16, 3), 13, 0, 1, dev).requires_grad_()
    b = _uniform((1, 8, 16, 48), 14, 0, 1, dev)
    flow = torch.zeros((1, 8, 16, 2), device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        wk.flow_warp_pair(a, b, flow, packed_out=True)
    with torch.no_grad():
        wk.flow_warp_pair(a, b, flow, packed_out=True)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One fp32 pair loss and gradient at 128x128, the same weights and
    batch on both devices: the loss within 1e-4 relative, the whole
    gradient within 1e-2 relative L2 and each key within 5e-2 (at random
    init many keys' f32 gradients are cancelling sums: the CPU's own f32
    and f64 gradients differ by up to about 1% on a key)."""
    from lssvc_tpu_torch.ops.nn import Mode, precision_scope
    from lssvc_tpu_torch.parallel import train as ptrain
    from lssvc_tpu_torch.train import SyntheticPairs, make_batch

    params = init_lssvc(torch.Generator().manual_seed(0))
    batch = make_batch(SyntheticPairs(128, 3), "pair", 1, 2, "cpu")[0]
    fn = ptrain.make_loss_fn(0.01, (128, 128))
    got = []
    for d in ("cpu", dev):
        with precision_scope(Mode("fp32")):
            loss, _, grads = ptrain.value_and_grad(
                fn, {k: v.to(d) for k, v in params.items()},
                {k: v.to(d) for k, v in batch.items()})
        got.append((float(loss), {k: v.cpu() for k, v in grads.items()}))
    (l_c, g_c), (l_d, g_d) = got
    assert abs(l_d - l_c) <= 1e-4 * abs(l_c)
    keys = sorted(g_c)
    whole = torch.cat([(g_d[k] - g_c[k]).ravel() for k in keys]).norm() \
        / torch.cat([g_c[k].ravel() for k in keys]).norm()
    assert float(whole) <= 1e-2
    for k, r in g_c.items():
        den = float(r.norm())
        err = float((g_d[k] - r).norm())
        assert err <= 5e-2 * den if den else err == 0, k


# ---------------------------------------------------------------------------
# The fixed-order variant of the backward kernels (deterministic flag)

def _same_bits(a, b):
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flows", ["random", "past"])
def test_fixed_order_flow_warp_backward(dev, dtype, flows):
    """Under the deterministic flag: one launch of the fixed-order variant, its
    gradients within the default path's bounds of the plain autograd
    (`_grad_tol`) and bit-equal across two launches."""
    n, h, w = 2, 37, 53
    a = _uniform((n, h, w, 3), 21, 0, 1, dev, dtype)
    b = _uniform((n, h, w, 48), 22, 0, 1, dev, dtype)
    span = 6 if flows == "random" else 3 * w  # "past": taps on the borders
    flow = _uniform((n, h, w, 2), 23, -span, span, dev)
    g_a = _uniform((n, h, w, 3), 24, -1, 1, dev, dtype)
    g_b = _uniform((n, h, w, 48), 25, -1, 1, dev, dtype)
    before = wk.flow_warp_backward.fixed_launches
    with deterministic():
        got = wk.flow_warp_backward(flow, a, g_a, b, g_b)
        again = wk.flow_warp_backward(flow, a, g_a, b, g_b)
    assert wk.flow_warp_backward.fixed_launches == before + 2
    ref = wk.flow_warp_backward_plain(flow, a, g_a, b, g_b)
    for x, y, z in zip(got, again, ref):
        assert _same_bits(x, y)
        _grad_tol(x, z, dtype if x.dtype == dtype else torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [8.0, 40.0])
def test_fixed_order_grouped_warp_backward(dev, dtype, offset):
    n, h, w, c_src, go, gn = 2, 21, 35, 48, 32, 16
    x = _uniform((n, h, w, c_src), 26, 0, 1, dev, dtype)
    fx = _uniform((n, h, w, go), 27, -offset, offset, dev)
    fy = _uniform((n, h, w, go), 28, -offset, offset, dev)
    mask = _uniform((n, h, w, go), 29, 0, 1, dev)
    g = _uniform((n, h, w, go * c_src // gn), 30, -1, 1, dev, dtype)
    before = wk.grouped_warp_backward.fixed_launches
    with deterministic():
        got = wk.grouped_warp_backward(x, fx, fy, mask, gn, g)
        again = wk.grouped_warp_backward(x, fx, fy, mask, gn, g)
    assert wk.grouped_warp_backward.fixed_launches == before + 2
    ref = wk.grouped_warp_backward_plain(x, fx, fy, mask, gn, g)
    for u, v, r in zip(got, again, ref):
        assert _same_bits(u, v)
        _grad_tol(u, r, dtype if u.dtype == dtype else torch.float32)


def test_train_step_is_reproducible_under_the_deterministic_flag(
        dev, monkeypatch):
    """Under `torch.use_deterministic_algorithms(True)` (cuBLAS's workspace
    set as PyTorch asks for it) two fp32 `pair` steps from the same state
    give bit-equal parameters."""
    from lssvc_tpu_torch.parallel import train as ptrain
    from lssvc_tpu_torch.train import SyntheticPairs, make_batch

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    batch = make_batch(SyntheticPairs(128, 3), "pair", 1, 2, dev)[0]
    opt = ptrain.Adam(1e-4)
    step = ptrain.make_train_step(opt, 0.01, (128, 128), precision="fp32")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        one, _, _ = step(params, opt.init(params), batch)
        two, _, _ = step(params, opt.init(params), batch)
    finally:
        torch.use_deterministic_algorithms(before)
    assert all(_same_bits(one[k], two[k]) for k in one)


# ---------------------------------------------------------------------------
# Row-local products in GEMMs of one shape (`ops.nn.rows_matmul`)

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_rows_matmul_strip_rows_equal_the_frame_rows(dev, precision):
    """On the card, GDN's product and OffsetDiversity's fusion product
    (`matmul_f32out`, bf16 operands with an f32 product in bf16) over a
    288 x 480 level (138,240 rows: four GEMMs of `ROWS_CUDA` rows and a
    padded fifth) and over strips of it (a half with a 16-row halo each
    side, a band of 40 rows): every strip's rows bit-equal to the
    frame's."""
    x = _uniform((1, 288, 480, 64), 31, -2, 2, dev)
    beta = _uniform((64,), 32, 0.5, 1.5, dev)
    gamma = _uniform((64, 64), 33, 0, 0.1, dev)
    w = _uniform((64, 48), 34, -0.1, 0.1, dev)
    with tnn.precision_scope(tnn.Mode(precision)):
        for fn in (lambda t: tnn.gdn(t, beta, gamma),
                   lambda t: tnn.matmul_f32out(t, w)):
            whole = fn(x)
            for lo, hi in ((0, 160), (128, 288), (37, 77)):
                part = fn(x[:, lo:hi].contiguous())
                assert torch.equal(part, whole[:, lo:hi]), (lo, hi)
