"""The port's ops (lssvc_tpu_torch.ops, .entropy) against the JAX package's.

Same inputs, made with numpy, through both; JAX on the CPU, the port on
CPU tensors.  Weights are drawn in the JAX layouts and reach the port
through the weight bridge `params_from_jax`.  Tolerance 1e-5 relative (the
two frameworks sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lssvc_tpu import ops as jops
from lssvc_tpu.convert import P as JP
from lssvc_tpu.entropy import models as jent
from lssvc_tpu.ops import warp as jwarp
from lssvc_tpu_torch import ops as tops
from lssvc_tpu_torch.convert import P as TP
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.entropy import models as tent

from torch_threads import share_cores

share_cores()

RTOL = 1e-5


def _r(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(port, ref, rtol=RTOL, atol=None):
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == ref.shape
    if atol is None:
        atol = rtol * max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,stride,groups,padding", [
    (3, 1, 1, None), (3, 2, 1, None), (1, 1, 1, None), (7, 1, 1, None),
    (3, 1, 8, None),   # depthwise (k, k, 1, C) -> (C, 1, k, k)
    (2, 2, 1, 0),      # DepthConv's stride-2 adaptor
    (1, 1, 4, None),   # grouped 1x1 (OffsetDiversity fusion)
])
def test_conv2d(k, stride, groups, padding):
    rng = np.random.default_rng(k * 10 + stride + groups)
    cin, cout = 8, 8 if groups == 8 else 12
    x = _r(rng, (2, 13, 18, cin))
    w = _r(rng, (k, k, cin // groups, cout), 0.2)
    b = _r(rng, (cout,))
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, padding=padding, groups=groups)
    tw = params_from_jax({"c.weight": w}, "dmc")["c.weight"]
    out = tops.conv2d(torch.from_numpy(x), tw, torch.from_numpy(b),
                      stride=stride, padding=padding, groups=groups)
    _close(out, ref)


@pytest.mark.parametrize("stride,padding,output_padding",
                         [(2, 1, 1), (1, 1, 0)])
def test_conv_transpose2d(stride, padding, output_padding):
    rng = np.random.default_rng(stride)
    x = _r(rng, (1, 9, 11, 6))
    w = _r(rng, (3, 3, 6, 10), 0.2)  # conv-equivalent flipped HWIO
    b = _r(rng, (10,))
    ref = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), stride=stride,
                                padding=padding, output_padding=output_padding)
    # DMC key: the bridge un-flips it into torch's (I, O, kH, kW)
    tw = params_from_jax({"mv_decoder.0.weight": w}, "dmc")["mv_decoder.0.weight"]
    assert tuple(tw.shape) == (6, 10, 3, 3)
    out = tops.conv_transpose2d(torch.from_numpy(x), tw, torch.from_numpy(b),
                                stride=stride, padding=padding,
                                output_padding=output_padding)
    _close(out, ref)


@pytest.mark.parametrize("stride,output_padding", [(2, 1), (1, 0)])
@pytest.mark.parametrize("shape", [(1, 9, 11, 6, 10), (2, 5, 7, 64, 2),
                                   (1, 1, 1, 3, 4)])
def test_conv_transpose2d_as_forward_convs(shape, stride, output_padding):
    """The forward-conv form equals torch's transposed conv within float32
    rounding (max |err| <= 4e-6 max |ref|, both held to a float64 one)."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(_r(rng, (n, h, w, cin)))
    wt = torch.from_numpy(_r(rng, (cin, cout, 3, 3)))
    b = torch.from_numpy(_r(rng, (cout,)))
    out = tops.conv_transpose2d(x, wt, b, stride=stride, padding=1,
                                output_padding=output_padding)
    ref = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2).double(), wt.double(), b.double(),
        stride=stride, padding=1, output_padding=output_padding
    ).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 4e-6 * float(ref.abs().max())
    with pytest.raises(ValueError, match="not a configuration"):
        tops.conv_transpose2d(x, wt, b, stride=2, padding=0)


def test_pixel_shuffle_and_pools():
    rng = np.random.default_rng(3)
    x = _r(rng, (2, 6, 8, 12))
    _close(tops.pixel_shuffle(torch.from_numpy(x), 2),
           jops.pixel_shuffle(jnp.asarray(x), 2), rtol=0, atol=0)
    _close(tops.avg_pool2d(torch.from_numpy(x), 2),
           jops.avg_pool2d(jnp.asarray(x), 2))
    _close(tops.max_pool2d(torch.from_numpy(x), 2),
           jops.max_pool2d(jnp.asarray(x), 2), rtol=0, atol=0)
    _close(tops.leaky_relu(torch.from_numpy(x), 0.1),
           jops.leaky_relu(jnp.asarray(x), 0.1), rtol=0, atol=0)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    rng = np.random.default_rng(4 + inverse)
    c = 16
    x = _r(rng, (1, 7, 9, c), 3.0)
    beta = np.abs(_r(rng, (c,))) + 0.5
    gamma = np.abs(_r(rng, (c, c), 0.1))
    gamma[:2, :2] = -1.0  # below the bound: exercises the clamp
    ref = jops.gdn(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma),
                   inverse=inverse)
    out = tops.gdn(torch.from_numpy(x), torch.from_numpy(beta),
                   torch.from_numpy(gamma), inverse=inverse)
    _close(out, ref)


def test_ste_round_ties_to_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.49999997, 7.3,
                  -7.7], np.float32)
    out = tops.ste_round(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jops.ste_round(jnp.asarray(x))))
    np.testing.assert_array_equal(out.numpy()[:7],
                                  [-2, -2, -0, 0, 2, 2, 4])


def test_resize_up2_down2_and_general():
    rng = np.random.default_rng(5)
    x = _r(rng, (2, 6, 10, 5))
    for hw in ((12, 20), (3, 5), (9, 15), (6, 10)):
        _close(tops.bilinear_resize(torch.from_numpy(x), hw),
               jwarp.bilinear_resize(jnp.asarray(x), hw))


def test_pad_nhwc_pads_and_crops():
    x = np.arange(2 * 5 * 6 * 3, dtype=np.float32).reshape(2, 5, 6, 3)
    for pad in ((1, 2, 0, 3), (-1, 2, -2, 0), (0, 0, 0, 0)):
        _close(tops.pad_nhwc(torch.from_numpy(x), pad),
               jops.pad_nhwc(jnp.asarray(x), pad), rtol=0, atol=0)


def test_clamp_flow_nonfinite():
    f = np.array([[[[np.nan, 3.0], [np.inf, -np.inf], [-500.0, 40.0],
                    [1.25, -0.5]]]], np.float32)  # (1, 1, 4, 2)
    ref = np.asarray(jwarp.clamp_flow(jnp.asarray(f), 30, 20))
    out = tops.clamp_flow(torch.from_numpy(f), 30, 20).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0, 0, 1], [20.0, -30.0])


def test_laplace_bits():
    rng = np.random.default_rng(6)
    y = np.round(_r(rng, (1, 8, 8, 16), 4.0))
    sigma = np.abs(_r(rng, (1, 8, 8, 16), 2.0))
    sigma[0, 0, 0, :4] = 0.0  # clamped to 1e-5
    bj, pj = jent.laplace_bits(jnp.asarray(y), jnp.asarray(sigma))
    bt, pt = tent.laplace_bits(torch.from_numpy(y), torch.from_numpy(sigma))
    _close(pt, pj)
    assert abs(float(bt) - float(bj)) <= RTOL * abs(float(bj))


def test_factorized_bits():
    rng = np.random.default_rng(7)
    c = 12
    jparams = {}
    for f in ("f1", "f2", "f3", "f4"):
        for n in (("h", "b") if f == "f4" else ("h", "b", "a")):
            jparams[f"be.{f}.{n}"] = _r(rng, (1, 1, 1, c), 0.5)
    z = np.round(_r(rng, (1, 6, 7, c), 3.0))
    bj, pj = jent.factorized_bits(
        JP({k: jnp.asarray(v) for k, v in jparams.items()}).sub("be"),
        jnp.asarray(z))
    tparams = params_from_jax(jparams, "dmc")
    assert tuple(tparams["be.f1.h"].shape) == (1, c, 1, 1)
    bt, pt = tent.factorized_bits(TP(tparams).sub("be"), torch.from_numpy(z))
    _close(pt, pj)
    assert abs(float(bt) - float(bj)) <= RTOL * abs(float(bj))
