"""Products that do not depend on the row count, and the warps' backward
wrappers under the deterministic flag, on the CPU.

`ops.nn.rows_matmul` runs GDN's `x^2 @ gamma^T`, the 1x1 convs taken as
matmuls and OffsetDiversity's fusion as GEMMs of one fixed row count, so
an H-strip's rows compute bit for bit as the same rows of its whole frame
(on the card cuBLAS picks its kernel, and the order of a row's sums, by
the matrix's shape).  GDN stays within the JAX parity test's tolerance
(`tests/test_torch_ops.py`, rtol 1e-5 of max |ref|).  The fixed-order
backward kernels themselves run only on the card
(`tests/test_torch_cuda.py`); here the wrappers' choice of path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lssvc_tpu import ops as jops
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
