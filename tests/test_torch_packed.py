"""The width-packed domain of the port against the JAX package's, on the CPU.

`ops/packed.py`'s kernel packing is numpy on both sides, so it is held bit
for bit; a packed conv is held to the plain conv within 1e-5
(`tests/test_packed.py:43-70`); the packed fp32 two-layer P-frame (EL
128x128 / BL 64x64, full widths, the 10 px OffsetDiversity cap on both
sides) to the JAX package's packed forward and to the port's plain forward
within the JAX package's own 2e-4 (`tests/test_packed.py:124-129`); the
fused packed pair warp (`LSSVC_PACKED_CTX`) to the default path as
`tests/test_lssvc.py:71-100` holds it; and the plain versions of the two
packed warp stores to `pack_width` of the JAX package's warps, bit for bit,
f32 and bf16.  Weights: the port's init, through the JAX package's
`convert_state_dict` and back through `params_from_jax`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_close_mostly
from lssvc_tpu.convert import convert_state_dict
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.ops import conv2d as jconv2d
from lssvc_tpu.ops import packed as jpk
from lssvc_tpu.ops.nn import set_od_offset_cap, set_packed_width
from lssvc_tpu.ops.warp_pallas import (
    _flow_warp_pallas_cblock,
    _grouped_warp_pallas_cblock,
    flow_warp_auto,
    grouped_warp_auto,
)
from lssvc_tpu_torch.convert import P, params_from_jax
from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models import lssvc as tl
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.models.packed_blocks import aux_pair_perm
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops import packed as tpk
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.ops.nn import Mode, conv2d, precision_scope

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)
DPB = ("ref_frame_bl", "ref_frame_el", "ref_feature_bl", "ref_feature_el")
PACKED_TOL = 2e-4  # the JAX package's packed-vs-plain bound


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params): the port's init through the JAX
    package's converter, and back through the bridge."""
    jparams = convert_state_dict(init_lssvc(torch.Generator().manual_seed(0)),
                                 jl.LSSVC.TRANSPOSED_CONV_KEYS)
    return jparams, params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "lssvc")


def _frame_inputs(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    return [a(*BL, 3), a(*EL, 3), a(*BL, 3), a(*EL, 3), a(*BL, 64),
            a(*EL, 48)]


def _port_frame(tparams, inputs, **mode):
    model = LSSVC(tparams, device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING,
                  **mode)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    return model.forward_one_frame(*(torch.from_numpy(v) for v in inputs))


def _jax_frame(jparams, inputs, packed_width):
    """The JAX package's forward with its process-wide packed width set,
    and fp32 and packed width 1 restored whatever happens (a later fp32
    parity test in the same worker must not run packed)."""
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)
    set_packed_width(packed_width)
    jax.clear_caches()
    try:
        return jl._fwd_jit(jparams, *(jnp.asarray(v) for v in inputs), EL,
                           2.0, (0, 0, 0, 0))
    finally:
        set_packed_width(1)
        set_od_offset_cap(None)
        jax.clear_caches()


def _close(a, b, tol=PACKED_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


CONV_CASES = [(2, 1, 3, 6, 5), (2, 1, 5, 4, 4), (2, 1, 7, 3, 8),
              (2, 2, 3, 6, 5), (2, 2, 5, 4, 4), (4, 1, 3, 3, 6),
              (4, 2, 3, 3, 6)]


@pytest.mark.parametrize("p,stride,k,cin,cout", CONV_CASES)
def test_pack_kernel_bit_equal_to_jax(rng, p, stride, k, cin, cout):
    """`pack_kernel` (HWIO numpy) equals the JAX package's bit for bit, and
    the OIHW torch packing is its transpose, bit for bit."""
    w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
    ours, pads = tpk.pack_kernel(w, p, stride)
    ref, ref_pads = jpk.pack_kernel(w, p, stride)
    assert pads == ref_pads
    np.testing.assert_array_equal(ours, np.asarray(ref))
    oihw, oihw_pads = tpk.pack_kernel_oihw(
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), p, stride)
    assert oihw_pads == pads
    np.testing.assert_array_equal(oihw.numpy(), ours.transpose(3, 2, 0, 1))


def test_pack_depthwise_and_bias_bit_equal_to_jax(rng):
    w = rng.standard_normal((3, 3, 1, 6), dtype=np.float32)
    ours, pads = tpk.pack_depthwise_kernel(w, 2)
    ref, ref_pads = jpk.pack_depthwise_kernel(w, 2)
    assert pads == ref_pads
    np.testing.assert_array_equal(ours, np.asarray(ref))
    oihw, _ = tpk.pack_depthwise_kernel_oihw(
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), 2)
    np.testing.assert_array_equal(oihw.numpy(), ours.transpose(3, 2, 0, 1))
    b = rng.standard_normal(6, dtype=np.float32)
    np.testing.assert_array_equal(tpk.pack_bias(b, 2),
                                  np.asarray(jpk.pack_bias(b, 2)))
    np.testing.assert_array_equal(tpk.pack_bias(torch.from_numpy(b), 2),
                                  np.asarray(jpk.pack_bias(b, 2)))


@pytest.mark.parametrize("p,stride,k,cin,cout", CONV_CASES)
def test_packed_conv_exact(rng, p, stride, k, cin, cout):
    """A packed conv equals the plain conv within 1e-5
    (`tests/test_packed.py:43-70`), and the JAX package's plain conv."""
    h, w = 8, 16 if (16 // stride) % p == 0 else 32
    x = rng.standard_normal((1, h, w, cin), dtype=np.float32)
    kern = rng.standard_normal((cout, cin, k, k), dtype=np.float32)
    bias = rng.standard_normal(cout, dtype=np.float32)
    xt, kt, bt = (torch.from_numpy(v) for v in (x, kern, bias))
    ref = conv2d(xt, kt, bt, stride=stride)
    pw, pads = tpk.pack_kernel_oihw(kt, p, stride)
    got = tpk.unpack_width(tpk.packed_conv2d(
        tpk.pack_width(xt, p), pw, tpk.pack_bias(bt, p), stride=stride,
        pad_lr=pads), p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    jref = jconv2d(jnp.asarray(x), jnp.asarray(kern.transpose(2, 3, 1, 0)),
                   jnp.asarray(bias), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-5)


def test_packed_depthwise_exact(rng):
    c, p = 6, 2
    x = torch.from_numpy(rng.standard_normal((1, 8, 16, c), dtype=np.float32))
    kern = torch.from_numpy(rng.standard_normal((c, 1, 3, 3),
                                                dtype=np.float32))
    ref = conv2d(x, kern, groups=c)
    pw, pads = tpk.pack_depthwise_kernel_oihw(kern, p)
    got = tpk.unpack_width(tpk.packed_conv2d(tpk.pack_width(x, p), pw,
                                             pad_lr=pads), p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_packed_forward_matches_jax_and_plain(params):
    """The fp32 two-layer P-frame at packed width 2 against the port's
    plain forward within 2e-4 everywhere, and against the JAX package's
    packed forward within 2e-4 but for the rare round-tie flips that
    `assert_close_mostly` allows (0.5% of elements; the port and the JAX
    package sum in other orders, packed or not); bits within the JAX
    package's own loose bound (quantisation flips under last-bit drift:
    2% + 100 bits)."""
    jparams, tparams = params
    inputs = _frame_inputs(31)
    packed = _port_frame(tparams, inputs, packed_width=2)
    plain = _port_frame(tparams, inputs)
    ref = _jax_frame(jparams, inputs, packed_width=2)
    for k in ("ref_frame_el", "ref_frame_bl", "ref_feature_el"):
        _close(packed["dpb"][k], plain["dpb"][k])
        assert_close_mostly(packed["dpb"][k].numpy(), ref["dpb"][k],
                            atol=PACKED_TOL, rtol=PACKED_TOL)
    for k in ("bit_el", "bit_bl"):
        for other in (float(ref[k]), float(plain[k])):
            assert abs(float(packed[k]) - other) <= 0.02 * abs(other) + 100
    # the packed kernels are cached on the model, not rebuilt every frame
    model = LSSVC(tparams, device="cpu", packed_width=2)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    model.forward_one_frame(*(torch.from_numpy(v) for v in inputs))
    cached = dict(model.mode.cache)
    assert cached and model.base_layer_model.mode.cache == {}
    model.forward_one_frame(*(torch.from_numpy(v) for v in inputs))
    assert all(model.mode.cache[k][1] is v[1] for k, v in cached.items())


def test_packed_ctx_matches_default(params):
    """The fused packed pair warp (the pair stored packed, OffsetDiversity's
    entry conv reading it through its permuted kernel) against the
    default packed path: warpframe within 1e-5, the contexts as the JAX
    package holds them (`tests/test_lssvc.py:71-100`)."""
    _, tparams = params
    rng = np.random.default_rng(9)
    ref_el = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    feat = torch.from_numpy(rng.random((1, 64, 64, 48), np.float32))
    mv = torch.from_numpy(rng.uniform(-1.5, 1.5, (1, 64, 64, 2))
                          .astype(np.float32))
    p = P({k: v for k, v in tparams.items()
           if not k.startswith("base_layer_model.")})
    out = {}
    for ctx in (False, True):
        with precision_scope(Mode(packed_width=2, packed_ctx=ctx, cache={})):
            out[ctx] = tl.el_motion_compensation(p, ref_el, feat, mv, 10.0)
    (ctx_a, wf_a), (ctx_b, wf_b) = out[False], out[True]
    np.testing.assert_allclose(wf_b.numpy(), wf_a.numpy(), atol=1e-5)
    for i, (a, b) in enumerate(zip(ctx_a, ctx_b)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-4,
                                   rtol=1e-3, err_msg=f"c{i + 1}")


def test_aux_pair_perm_matches_jax():
    from lssvc_tpu.models.lssvc_blocks import _aux_pair_perm

    np.testing.assert_array_equal(aux_pair_perm(51, 53), _aux_pair_perm(51, 53))


def _warp_inputs(seed, shape, go=None):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    if go is None:
        return x, rng.uniform(-3, 3, (n, h, w, 2)).astype(np.float32)
    fx, fy = (rng.uniform(-3, 3, (n, h, w, go)).astype(np.float32)
              for _ in range(2))
    return x, fx, fy, rng.uniform(0, 1, (n, h, w, go)).astype(np.float32)


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t if dtype == "float32" else t.to(torch.bfloat16)


def _j(x, dtype):
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ca,cb,nhw", [
    pytest.param(3, 48, (1, 12, 40), id="3-48"),
    pytest.param(3, 5, (1, 12, 40), id="3-5"),
    # the card tests' shapes (tests/test_torch_cuda.py PACKED_PAIR_CASES)
    pytest.param(3, 48, (2, 21, 70), id="3-48-2x21x70"),
    pytest.param(3, 5, (2, 21, 70), id="3-5-2x21x70"),
    pytest.param(4, 60, (2, 21, 70), id="4-60-2x21x70"),
    pytest.param(8, 120, (2, 21, 70), id="8-120-2x21x70"),
    pytest.param(3, 48, (1, 21, 128), id="3-48-1x21x128"),
])
def test_pair_packed_store_plain_matches_jax(dtype, ca, cb, nhw):
    """The packed pair store's plain version (concat, warp, view) against
    the JAX package's `flow_warp_auto(concat([a, b]), packed_out=True)`
    (its non-TPU path: the XLA warp and `pack_width`), bit for bit, at
    every shape the card tests hold the kernel to this plain version; the
    JAX warp of a bf16 source returns f32, which the port rounds once."""
    n, h, w = nhw
    x, flow = _warp_inputs(81, (n, h, w, ca + cb))
    a, b = x[..., :ca].copy(), x[..., ca:].copy()
    out = wk.flow_warp_pair(_as(a, dtype), _as(b, dtype),
                            torch.from_numpy(flow), packed_out=True)
    ref = flow_warp_auto(_j(x, dtype), jnp.asarray(flow), packed_out=True)
    assert out.shape == (n, h, w // 2, 2 * (ca + cb)) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(dtype), np.float32))
    single = wk.flow_warp(_as(x, dtype), torch.from_numpy(flow),
                          packed_out=True)
    assert torch.equal(single, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_packed_store_plain_matches_jax(dtype):
    """The grouped warp's packed store, plain version, against the JAX
    package's `grouped_warp_auto(..., packed_out=True)`, bit for bit, at
    OffsetDiversity's channel plan (48 -> 96, 32 units)."""
    x, fx, fy, m = _warp_inputs(83, (1, 8, 24, 48), go=32)
    out = wk.grouped_warp(_as(x, dtype), *(torch.from_numpy(v)
                                           for v in (fx, fy, m)), 16,
                          packed_out=True)
    ref = grouped_warp_auto(_j(x, dtype), *(jnp.asarray(v)
                                            for v in (fx, fy, m)), 16,
                            packed_out=True)
    assert out.shape == (1, 8, 12, 192) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(dtype), np.float32))


def test_packed_stores_match_the_pallas_kernels():
    """The plain packed stores against the Pallas kernels' own packed
    stores in interpret mode (`nhwc_out="p"`), within their 2e-6
    (`tests/test_warp_pallas.py:284-335`), f32: the tiny-tier single warp
    on the pair's 3 + 48 channels and the grouped warp."""
    x, flow = _warp_inputs(85, (1, 16, 128, 51))
    x = (x * 0.5).astype(np.float32)
    flow = np.clip(flow, -2, 2)
    out = wk.flow_warp_pair(torch.from_numpy(x[..., :3].copy()),
                            torch.from_numpy(x[..., 3:].copy()),
                            torch.from_numpy(flow), packed_out=True)
    ref = _flow_warp_pallas_cblock(jnp.asarray(x), jnp.asarray(flow[..., 0]),
                                   jnp.asarray(flow[..., 1]), 2, 3, 63,
                                   packed_out=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
    xg, fx, fy, m = _warp_inputs(87, (1, 16, 128, 8), go=8)
    fx, fy = np.clip(fx, -2, 2), np.clip(fy, -2, 2)
    out = wk.grouped_warp(*(torch.from_numpy(v) for v in (xg, fx, fy, m)), 4,
                          packed_out=True)
    ref = _grouped_warp_pallas_cblock(*(jnp.asarray(v)
                                        for v in (xg, fx, fy, m)), 4, 2, 3,
                                      63, packed_out=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_packed_stores_need_an_even_width():
    x = torch.zeros((1, 4, 5, 3))
    with pytest.raises(ValueError, match="even width"):
        wk.flow_warp_pair(x, x, torch.zeros((1, 4, 5, 2)), packed_out=True)
    with pytest.raises(ValueError, match="even width"):
        wk.grouped_warp(torch.zeros((1, 4, 5, 6)), *(torch.zeros((1, 4, 5, 4))
                                                     for _ in range(3)), 2,
                        packed_out=True)
