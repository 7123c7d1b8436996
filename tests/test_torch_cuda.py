"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a host without CUDA.  On a GPU host,
`python -m pytest tests/test_torch_cuda.py -q` builds the kernels from
lssvc_tpu_torch/csrc and runs them; nothing here imports JAX.
"""

import numpy as np
import pytest
import torch

from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.ops import conv_chain as cc
from lssvc_tpu_torch.ops import warp as plain
from lssvc_tpu_torch.ops import warp_kernels as wk

pytestmark = pytest.mark.cuda


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
