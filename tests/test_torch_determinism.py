"""Products that do not depend on the row count, the warps' backward
wrappers under the deterministic flag and the plain versions of their
fixed-order variant, on the CPU.

`ops.nn.rows_matmul` runs GDN's `x^2 @ gamma^T`, the 1x1 convs taken as
matmuls and OffsetDiversity's fusion as GEMMs of one fixed row count, so
an H-strip's rows compute bit for bit as the same rows of its whole frame
(on the card cuBLAS picks its kernel, and the order of a row's sums, by
the matrix's shape).  GDN stays within the JAX parity test's tolerance
(`tests/test_torch_ops.py`, rtol 1e-5 of max |ref|).  The fixed-order
backward kernels themselves run only on the card
(`tests/test_torch_cuda.py`, bit for bit against the plain versions
here); here the wrappers' choice of path, and the plain versions
(`flow_warp_backward_fixed_plain`, `grouped_warp_backward_fixed_plain`:
each tap's value as round(v 2^s) summed in int64, converted once) against
`jax.grad` of the JAX package's warp formulas, under permutation of their
contributions, and at NaN flows and flows far past the borders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lssvc_tpu import ops as jops
from lssvc_tpu.ops import warp as jwarp
from lssvc_tpu.ops import warp_pallas as jwp
from lssvc_tpu_torch.ops import nn as tnn
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.tools.warp_bench import deterministic

from torch_threads import share_cores

share_cores()

# rows of the frame: 48 x 40 = 1920, so the CPU's 1024-row GEMMs take the
# frame in two chunks and each strip in one, padded
FRAME = (1, 48, 40)
STRIPS = ((0, 24), (20, 48), (7, 11))


def _r(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _strip_rows_equal(fn, x):
    """fn on each strip of x's rows against the same rows of fn(x): bit
    for bit."""
    whole = fn(x)
    for lo, hi in STRIPS:
        part = fn(x[:, lo:hi].contiguous())
        assert torch.equal(part, whole[:, lo:hi]), (lo, hi)
    return whole


@pytest.mark.parametrize("rows", [None, 7])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_strip_rows_equal_the_frame_rows(monkeypatch, rows, inverse):
    """gdn on a strip's rows is bit-equal to those rows of the frame's gdn
    (at the CPU's GEMM rows, and at 7: many chunks, the last padded); the
    frame's within the JAX gdn's rtol 1e-5."""
    if rows is not None:
        monkeypatch.setattr(tnn, "ROWS_CPU", rows)
    rng = np.random.default_rng(40 + inverse)
    c = 32
    x = _r(rng, (*FRAME, c), 3.0)
    beta = np.abs(_r(rng, (c,))) + 0.5
    gamma = np.abs(_r(rng, (c, c), 0.1))
    gamma[:2, :2] = -1.0  # below the bound: the clamp
    tb, tg = torch.from_numpy(beta), torch.from_numpy(gamma)
    whole = _strip_rows_equal(
        lambda t: tnn.gdn(t, tb, tg, inverse=inverse), torch.from_numpy(x))
    ref = np.asarray(jops.gdn(jnp.asarray(x), jnp.asarray(beta),
                              jnp.asarray(gamma), inverse=inverse))
    np.testing.assert_allclose(whole.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_matmul_f32out_strip_rows_equal_the_frame_rows(precision):
    """OffsetDiversity's fusion product (`matmul_f32out`) in both of its
    modes: a strip's rows bit-equal to the frame's; equal to one plain
    product of the (bf16-rounded) operands within 1e-5 relative."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(_r(rng, (*FRAME, 96)))
    w = torch.from_numpy(_r(rng, (96, 48), 0.1))
    with tnn.precision_scope(tnn.Mode(precision)):
        whole = _strip_rows_equal(lambda t: tnn.matmul_f32out(t, w), x)
    assert whole.dtype == torch.float32
    xs, ws = (x, w) if precision == "fp32" else (
        x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())
    ref = (xs.double() @ ws.double()).float()
    torch.testing.assert_close(whole, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def test_conv1x1_as_matmul_strip_rows_equal_the_frame_rows():
    """The 1x1-as-matmul route (`Mode(conv1x1_einsum=True)`): a strip's
    rows bit-equal to the frame's, and within 1e-5 of F.conv2d's."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(_r(rng, (*FRAME, 64)))
    w = torch.from_numpy(_r(rng, (32, 64, 1, 1), 0.1))
    b = torch.from_numpy(_r(rng, (32,)))
    with tnn.precision_scope(tnn.Mode("fp32", conv1x1_einsum=True)):
        whole = _strip_rows_equal(lambda t: tnn.conv2d(t, w, b), x)
    with tnn.precision_scope(tnn.Mode("fp32")):
        ref = tnn.conv2d(x, w, b)
    torch.testing.assert_close(whole, ref, rtol=1e-5, atol=1e-5)


def test_rows_matmul_takes_gradients_through_its_chunks(monkeypatch):
    """Under autograd (training) the chunked product differentiates as one
    matmul: its gradients within 1e-5 of torch.matmul's."""
    monkeypatch.setattr(tnn, "ROWS_CPU", 5)
    rng = np.random.default_rng(43)
    a = torch.from_numpy(_r(rng, (2, 3, 4, 8))).requires_grad_()
    b = torch.from_numpy(_r(rng, (8, 6))).requires_grad_()
    g = torch.from_numpy(_r(rng, (2, 3, 4, 6)))
    got = torch.autograd.grad(tnn.rows_matmul(a, b), (a, b), g)
    ref = torch.autograd.grad(torch.matmul(a, b), (a, b), g)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_backward_wrappers_follow_the_deterministic_flag():
    """The wrappers read torch.use_deterministic_algorithms (set here for a
    block and restored after, by `tools/warp_bench.py`'s `deterministic`);
    on the CPU either way is the plain autograd (no launch), the same
    values."""
    before = torch.are_deterministic_algorithms_enabled()
    rng = np.random.default_rng(44)
    a = torch.from_numpy(_r(rng, (1, 9, 11, 3)))
    flow = torch.from_numpy(_r(rng, (1, 9, 11, 2), 3.0))
    g = torch.from_numpy(_r(rng, (1, 9, 11, 3)))
    launches = (wk.flow_warp_backward.launches,
                wk.flow_warp_backward.fixed_launches)
    with deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        fixed = wk.flow_warp_backward(flow, a, g)
    assert torch.are_deterministic_algorithms_enabled() == before
    default = wk.flow_warp_backward(flow, a, g)
    assert (wk.flow_warp_backward.launches,
            wk.flow_warp_backward.fixed_launches) == launches
    for x, y in zip(fixed, default):
        assert (x is None and y is None) or torch.equal(x, y)


# ---------------------------------------------------------------------------
# The plain versions of the fixed-order variant

FIXED_FLOWS = ["random", "smooth", "integer_on_border", "past_borders"]


def _fixed_flows(kind, rng, shape, w):
    if kind == "random":
        return _r(rng, shape, 3.0)
    if kind == "smooth":  # a 12 px field varying over 8 pixels
        n, h, _, c = shape
        coarse = rng.uniform(-12, 12, (n, h // 8 + 2, w // 8 + 2, c))
        y, x = np.arange(h) // 8, np.arange(w) // 8
        return coarse[:, y][:, :, x].astype(np.float32) + _r(rng, shape, 0.3)
    if kind == "past_borders":
        return rng.uniform(-3 * w, 3 * w, shape).astype(np.float32)
    return np.round(rng.uniform(-w, w, shape)).astype(np.float32)


def _max_rel(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    top = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= rel * top


def _pair_case(kind, seed, n=2, h=11, w=13):
    rng = np.random.default_rng(seed)
    a = rng.random((n, h, w, 3), np.float32)
    b = rng.random((n, h, w, 8), np.float32)
    flow = _fixed_flows(kind, rng, (n, h, w, 2), w)
    return a, b, flow, _r(rng, a.shape), _r(rng, b.shape)


def _grouped_case(kind, seed, n=2, h=9, w=13, c_src=12, go=8, gn=4):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, c_src), np.float32)
    fx, fy = (_fixed_flows(kind, rng, (n, h, w, go), w) for _ in range(2))
    mask = rng.random((n, h, w, go), np.float32)
    return x, fx, fy, mask, gn, _r(rng, (n, h, w, go * c_src // gn))


@pytest.mark.parametrize("flows", FIXED_FLOWS)
def test_flow_fixed_plain_matches_jax(flows):
    """The pair's fixed-order source gradients against `jax.grad` of the
    JAX package's `flow_warp` (`lssvc_tpu/ops/warp.py`) of both sources
    concatenated, f32 within 1e-5 max|ref|."""
    a, b, flow, ga, gb = _pair_case(flows, 50)
    t = torch.from_numpy
    _, got_a, got_b = wk.flow_warp_backward_fixed_plain(
        t(flow), t(a), t(ga), t(b), t(gb))
    wt = jnp.asarray(np.concatenate([ga, gb], -1))
    ref_a, ref_b = jax.grad(
        lambda x, y: (jwarp.flow_warp(jnp.concatenate([x, y], -1),
                                      jnp.asarray(flow)) * wt).sum(),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    _max_rel(got_a.numpy(), ref_a)
    _max_rel(got_b.numpy(), ref_b)
    # a source that takes no gradient is not summed and sets no scale
    _, only_a, none_b = wk.flow_warp_backward_fixed_plain(
        t(flow), t(a), t(ga), t(b), t(gb), need_b=False)
    assert none_b is None
    _max_rel(only_a.numpy(), ref_a)


@pytest.mark.parametrize("flows", FIXED_FLOWS)
def test_grouped_fixed_plain_matches_jax(flows):
    """The grouped warp's fixed-order source gradient against `jax.grad` of
    the JAX package's grouped formula (`grouped_warp_auto` on the CPU:
    `flow_warp_grouped` of `lssvc_tpu/ops/warp.py` times the mask), f32
    within 1e-5 max|ref|; its flow and mask gradients are the plain
    autograd's."""
    x, fx, fy, mask, gn, g = _grouped_case(flows, 51)
    t = torch.from_numpy
    got = wk.grouped_warp_backward_fixed_plain(t(x), t(fx), t(fy), t(mask),
                                               gn, t(g))
    ref = jax.grad(lambda a, b, c, m: (jwp.grouped_warp_auto(a, b, c, m, gn)
                                       * jnp.asarray(g)).sum(),
                   argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in
                                           (x, fx, fy, mask)))
    for u, r in zip(got, ref):
        _max_rel(u.numpy(), r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["pair", "grouped"])
def test_fixed_sums_do_not_depend_on_the_order(kind, dtype):
    """The fixed-order sum of the contributions in a random order is the
    same bits as in the kernels' order, in f32 and in bf16; a bf16 sum is
    the f32 one rounded once more at most (within half a bf16 ulp)."""
    t = torch.from_numpy
    if kind == "pair":
        a, b, flow, ga, gb = _pair_case("smooth", 52)
        contribs = list(wk._flow_fixed_contribs(t(flow), t(b), t(gb)))
        shape, grads, k = b.shape, [gb], b.shape[1] * b.shape[2]
        s = wk.fixed_exp([float(np.abs(gb).max())], k)
    else:
        x, fx, fy, mask, gn, g = _grouped_case("smooth", 53)
        contribs = list(wk.grouped_fixed_contribs(t(x), t(fx), t(fy),
                                                  t(mask), gn, t(g)))
        shape = x.shape
        s = wk.fixed_exp([float(np.abs(g).max()), float(mask.max())],
                         x.shape[1] * x.shape[2] * 2)
    count = sum(v.numel() for v, _ in contribs)
    order = torch.randperm(count, generator=torch.Generator().manual_seed(5))
    first = wk.fixed_total(contribs, shape, s, dtype)
    again = wk.fixed_total(contribs, shape, s, dtype, order=order)
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    if dtype == torch.bfloat16:
        f32 = wk.fixed_total(contribs, shape, s, torch.float32)
        assert bool(((first.float() - f32).abs()
                     <= 2.0 ** -8 * f32.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flows", ["nan", "far"])
def test_fixed_plain_at_nan_and_far_flows(flows, dtype):
    """NaN flows (a tenth of them, their taps at pixel 0 with NaN weights)
    and flows far past the borders (every tap clamped onto an edge pixel):
    the plain fixed-order gradients against the plain autograd of the
    port's warps (NaN in the same places; f32 within 1e-5 max|ref|, bf16
    within 1e-2 relative RMS), a non-finite sum NaN with the bits of
    float("nan")."""
    rng = np.random.default_rng(54)
    n, h, w = 2, 9, 11
    a = torch.from_numpy(rng.random((n, h, w, 5), np.float32)).to(dtype)
    flow = rng.uniform(-6, 6, (n, h, w, 2)).astype(np.float32)
    if flows == "nan":
        flow[rng.random(flow.shape) < 0.1] = np.nan
    else:
        flow = rng.uniform(-30 * w, 30 * w, flow.shape).astype(np.float32)
    g = torch.from_numpy(_r(rng, (n, h, w, 5))).to(dtype)
    fl = torch.from_numpy(flow)
    _, got, _ = wk.flow_warp_backward_fixed_plain(fl, a, g)
    _, ref, _ = wk.flow_warp_backward_plain(fl, a, g)
    assert got.dtype == dtype
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any()) == (flows == "nan")
    if flows == "nan":
        want = torch.tensor(float("nan"), dtype=dtype).view(
            torch.int16 if dtype == torch.bfloat16 else torch.int32)
        bits = got.view(torch.int16 if dtype == torch.bfloat16
                        else torch.int32)
        assert bool((bits[nan] == want).all())
    g32, r32 = got.float().masked_fill(nan, 0), ref.float().masked_fill(nan, 0)
    if dtype == torch.float32:
        _max_rel(g32.numpy(), r32.numpy())
    else:
        assert float((g32 - r32).norm() / r32.norm()) <= 1e-2
