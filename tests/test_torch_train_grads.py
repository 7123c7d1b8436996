"""The port's gradients against `jax.grad` of the JAX package, on the CPU.

Three layers of the training path:

* the bounds whose tie gradient `torch.clamp` would get wrong (the warps'
  sample clip, GDN's reparameterisation bounds, the bit clip, the Laplace
  scale bound and OffsetDiversity's offset cap), and ReLU and leaky ReLU
  at 0: each differentiated by both frameworks with its input on the tie,
  where `jnp.clip` and `jnp.maximum` give the input half the gradient;
* the plain warp twins (`ops/warp.py`), which the CPU trains through and
  the CUDA backward kernels are held to on the card, against `jax.grad` of
  the XLA formulas the JAX train step takes (`flow_warp_auto` and
  `grouped_warp_auto` off the TPU): max |err| <= 1e-5 max|ref| (the
  scatter-adds sum in another order);
* each training loss at crop 128, batch 1, fp32, from `params_from_jax`
  of the JAX init (`pair` and `warp` here; `spynet`, `cascade` and `intra`
  in `test_torch_train.py`): the loss within 1e-4 relative, each
  parameter's gradient as `check_loss_and_gradients` says.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lssvc_tpu.convert import P as JP
from lssvc_tpu.entropy import models as jent
from lssvc_tpu.models import lssvc_blocks as jblocks
from lssvc_tpu.models.init import init_dmc as j_init_dmc
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.ops import nn as jnn
from lssvc_tpu.ops import warp_pallas as jwp
from lssvc_tpu.parallel import train as jtrain
from lssvc_tpu_torch.convert import P as TP
from lssvc_tpu_torch.convert import params_from_jax, params_to_jax
from lssvc_tpu_torch.entropy import models as tent
from lssvc_tpu_torch.models import lssvc_blocks as tblocks
from lssvc_tpu_torch.ops import nn as tnn
from lssvc_tpu_torch.ops import warp as twarp
from lssvc_tpu_torch.parallel import train as ttrain
from lssvc_tpu_torch.train import SyntheticPairs, downsample_bl

from torch_threads import share_cores

share_cores()

CROP = 128


@pytest.fixture(autouse=True)
def jax_fp32():
    """The JAX package's process-wide modes as its train step runs them
    (fp32, packed width 1, no offset cap), restored after."""
    jnn.set_precision_mode("fp32")
    jnn.set_packed_width(1)
    jnn.set_od_offset_cap(None)
    try:
        yield
    finally:
        jnn.set_precision_mode("fp32")
        jnn.set_packed_width(1)
        jnn.set_od_offset_cap(None)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _torch_grads(fn, *args):
    ins = [_t(a).requires_grad_() for a in args]
    out = fn(*ins)
    return [g.numpy() for g in torch.autograd.grad(out, ins)]


def _jax_grads(fn, *args):
    got = jax.grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a, jnp.float32) for a in args])
    return [np.asarray(g) for g in got]


def _assert_max_rel(got, ref, rel=1e-5):
    top = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= rel * top, f"max |err| {err:.3g} at max |ref| {top:.3g}"


# ---------------------------------------------------------------------------
# The tie repairs

def _weighted(fn, w):
    """A scalar of fn's output that gives every element its own gradient."""
    return lambda *a: (fn(*a) * w).sum()


@pytest.mark.parametrize("flows", ["zero", "integer_border"])
def test_warp_clip_tie_matches_jax(flows):
    """Zero flow puts every left-column and top-row sample on the clip's
    lower bound; integer flows that land on column 0 or row 0 do too: JAX
    halves their flow gradient."""
    rng = np.random.default_rng(1)
    n, h, w, c = 1, 6, 7, 3
    x = rng.random((n, h, w, c), np.float32)
    if flows == "zero":
        flow = np.zeros((n, h, w, 2), np.float32)
    else:  # sample at (0, 0) from every pixel, and past it from some
        iy, ix = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        flow = np.stack([-ix, -iy], -1)[None].astype(np.float32)
        flow[..., 3:, :] -= 1.0
    wt = rng.standard_normal((n, h, w, c)).astype(np.float32)
    got = _torch_grads(_weighted(twarp.flow_warp, _t(wt)), x, flow)
    ref = _jax_grads(_weighted(lambda a, f: jwp.flow_warp_auto(a, f),
                               jnp.asarray(wt)), x, flow)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    # the tie is hit: JAX's flow gradient there is half the untied one
    assert np.any(ref[1] != 0)


def test_gdn_bounds_tie_matches_jax():
    """At init every off-diagonal GDN gamma sits on its lower bound
    (`sqrt(pedestal)` = 2^-18): JAX gives it half the gradient."""
    jp = j_init_dmc(seed=0)
    beta = np.asarray(jp["mv_encoder.1.beta"])
    gamma = np.asarray(jp["mv_encoder.1.gamma"])
    assert np.any(gamma == np.float32(2.0 ** -18))
    x = np.random.default_rng(2).standard_normal(
        (1, 4, 5, beta.shape[0])).astype(np.float32)
    wt = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    got = _torch_grads(_weighted(tnn.gdn, _t(wt)), x, beta, gamma)
    ref = _jax_grads(_weighted(jnn.gdn, jnp.asarray(wt)), x, beta, gamma)
    for g, r in zip(got, ref):  # a tie's gradient off by 2x would fail
        _assert_max_rel(g, r)


def test_bits_clip_ties_match_jax():
    """likelihood_to_bits on its lower tie (probs + 1e-5 == 1: bits 0) and
    past its upper bound (probs + 1e-5 == 0: bits inf -> 50); bits of
    exactly 50 need probs + 1e-5 = 2^-50, which f32 cannot reach from
    probs >= -1e-5, so the bound itself is held to `jnp.clip` at 0 and 50."""
    one = np.float32(1.0) - np.float32(1e-5)
    probs = np.array([one, -np.float32(1e-5), 0.3, 0.7], np.float32)
    assert np.float32(probs[0] + np.float32(1e-5)) == 1.0
    got = _torch_grads(tent.likelihood_to_bits, probs)
    ref = _jax_grads(jent.likelihood_to_bits, probs)
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(ref[0]))
    np.testing.assert_allclose(np.nan_to_num(got[0]), np.nan_to_num(ref[0]),
                               rtol=1e-6)
    v = np.array([0.0, 50.0, -1.0, 51.0, 7.0], np.float32)
    got = _torch_grads(lambda a: tnn.clip(a, 0.0, 50.0).sum(), v)
    ref = _jax_grads(lambda a: jnp.clip(a, 0.0, 50.0).sum(), v)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], [0.5, 0.5, 0.0, 0.0, 1.0])


def test_laplace_scale_tie_matches_jax():
    """A Laplace scale exactly on its 1e-5 lower bound."""
    y = np.array([0.0, 1.0, -2.0, 3.0], np.float32)
    sigma = np.array([1e-5, 1e-5, 0.5, 2.0], np.float32)
    got = _torch_grads(lambda a, s: tent.laplace_bits(a, s)[0], y, sigma)
    ref = _jax_grads(lambda a, s: jent.laplace_bits(a, s)[0], y, sigma)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_relu_and_leaky_relu_ties_match_jax():
    """At 0 JAX's `maximum(x, 0)` gives half the gradient and its leaky
    ReLU (`where(x >= 0, ...)`) all of it; F.relu gives none and
    F.leaky_relu the slope.  Under autograd the port's take JAX's."""
    v = np.array([0.0, -0.0, -1.5, 2.0], np.float32)
    got = _torch_grads(lambda a: tnn.relu(a).sum(), v)[0]
    np.testing.assert_array_equal(got, _jax_grads(
        lambda a: jnn.relu(a).sum(), v)[0])
    got = _torch_grads(lambda a: tnn.leaky_relu(a, 0.1).sum(), v)[0]
    np.testing.assert_array_equal(got, _jax_grads(
        lambda a: jnn.leaky_relu(a, 0.1).sum(), v)[0])
    np.testing.assert_array_equal(got, np.float32([1.0, 1.0, 0.1, 1.0]))


def _tie_value(cap, mag=40.0):
    """An f32 v near atanh(cap / mag) whose offset tanh(v) * mag is exactly
    cap in both frameworks and which the 2x bilinear upsample keeps."""
    bits = np.float32(np.arctanh(cap / mag)).view(np.int32)
    for k in sorted(range(-300, 301), key=abs):
        v = np.int32(bits + k).view(np.float32)
        t = float(torch.tanh(torch.tensor(v)) * mag)
        j = float(jnp.tanh(jnp.float32(v)) * mag)
        up = np.float32(0.75) * v + np.float32(0.25) * v
        if t == cap and j == cap and up == v:
            return v
    raise AssertionError("no f32 value puts the offset on the cap")


def test_offset_cap_tie_matches_jax():
    """OffsetDiversity's capped offsets, with the offset head's output set
    so that every offset equals the cap (zero weights, a bias on the tie):
    the bias's gradient through the cap is JAX's, halved at the tie; and
    the capped module's gradient on random inputs equals JAX's."""
    cap = 10.0
    jp = dict(j_init_lssvc(seed=0))
    v = _tie_value(cap)
    w4 = np.asarray(jp["align.conv_offset.4.weight"])
    b4 = np.asarray(jp["align.conv_offset.4.bias"]).copy()
    jp["align.conv_offset.4.weight"] = jnp.zeros_like(w4)
    b4[:64] = v  # the 64 offset channels; the 32 mask channels keep theirs
    jp["align.conv_offset.4.bias"] = jnp.asarray(b4)
    tp = params_from_jax({k: np.asarray(a) for k, a in jp.items()}, "lssvc")
    rng = np.random.default_rng(4)
    # 24 px wide: a sample 10 px right of most pixels lands inside
    x = rng.random((1, 24, 24, 48), np.float32)
    aux = rng.random((1, 24, 24, 53), np.float32)
    flow = rng.uniform(-2, 2, (1, 24, 24, 2)).astype(np.float32)
    wt = rng.standard_normal((1, 24, 24, 48)).astype(np.float32)
    key = "align.conv_offset.4.bias"

    def t_fn(b):
        q = dict(tp, **{key: b})
        return (tblocks.offset_diversity(TP(q).sub("align"), _t(x), _t(aux),
                                         _t(flow), offset_cap=cap)
                * _t(wt)).sum()

    def j_fn(b):
        q = dict(jp, **{key: b})
        return (jblocks.offset_diversity(JP(q).sub("align"), jnp.asarray(x),
                                         jnp.asarray(aux), jnp.asarray(flow))
                * jnp.asarray(wt)).sum()

    jnn.set_od_offset_cap(cap)
    got = _torch_grads(t_fn, b4)[0]
    ref = _jax_grads(j_fn, b4)[0]
    assert np.any(ref[:64] != 0)
    # every offset is on the tie, so a clamp's gradient would double these
    _assert_max_rel(got, ref)


# ---------------------------------------------------------------------------
# The plain warp twins' autograd

FLOWS = ["random", "past_borders", "integer_on_border"]


def _flows(kind, rng, shape, h, w):
    if kind == "random":
        return rng.uniform(-3, 3, shape).astype(np.float32)
    if kind == "past_borders":
        return rng.uniform(-3 * w, 3 * w, shape).astype(np.float32)
    # integer flows, many landing exactly on a border
    return np.round(rng.uniform(-w, w, shape)).astype(np.float32)


@pytest.mark.parametrize("flows", FLOWS)
def test_flow_warp_twin_grad_matches_jax(flows):
    rng = np.random.default_rng(5)
    n, h, w, c = 2, 9, 13, 5
    x = rng.random((n, h, w, c), np.float32)
    flow = _flows(flows, rng, (n, h, w, 2), h, w)
    wt = rng.standard_normal((n, h, w, c)).astype(np.float32)
    got = _torch_grads(_weighted(twarp.flow_warp, _t(wt)), x, flow)
    ref = _jax_grads(_weighted(jwp.flow_warp_auto, jnp.asarray(wt)), x,
                     flow)
    for g, r in zip(got, ref):
        _assert_max_rel(g, r)


@pytest.mark.parametrize("flows", FLOWS)
def test_grouped_warp_twin_grad_matches_jax(flows):
    rng = np.random.default_rng(6)
    n, h, w, c_src, go, gn = 2, 9, 13, 12, 8, 4
    x = rng.random((n, h, w, c_src), np.float32)
    fx = _flows(flows, rng, (n, h, w, go), h, w)
    fy = _flows(flows, rng, (n, h, w, go), h, w)
    mask = rng.random((n, h, w, go), np.float32)
    wt = rng.standard_normal((n, h, w, go * c_src // gn)).astype(np.float32)

    def t_fn(a, b, c, m):
        return (twarp.grouped_warp_plain(a, b, c, m, gn) * _t(wt)).sum()

    def j_fn(a, b, c, m):
        return (jwp.grouped_warp_auto(a, b, c, m, gn)
                * jnp.asarray(wt)).sum()

    got = _torch_grads(t_fn, x, fx, fy, mask)
    ref = _jax_grads(j_fn, x, fx, fy, mask)
    for g, r in zip(got, ref):
        _assert_max_rel(g, r)


# ---------------------------------------------------------------------------
# The losses

def _batch(loss, seed=0):
    """A synthetic batch as numpy arrays (the trainer's generator and BL
    downsample), fed to both packages."""
    data = SyntheticPairs(CROP, seed)
    if loss == "cascade":
        x_el = data.next_sequences(1, 3)
        return {"x_el": x_el,
                "x_bl": downsample_bl(torch.from_numpy(x_el)).numpy()}
    ref_el, x_el = data.next_batch(1)
    b = {"x_el": x_el, "x_bl": downsample_bl(torch.from_numpy(x_el)).numpy()}
    if loss != "intra":
        b["ref_el"] = ref_el
        b["ref_bl"] = downsample_bl(torch.from_numpy(ref_el)).numpy()
    return b


def _jax_loss_and_grads(jparams, batch, loss):
    shape = (CROP, CROP)
    if loss == "intra":
        def fn(p, b):
            return jtrain.rd_loss_intra(p, b, 0.01, shape)
    elif loss == "cascade":
        def fn(p, b):
            return jtrain.rd_loss_cascade(p, b, 0.01, shape, 2.0,
                                          (0, 0, 0, 0), warm=1)
    else:
        base = jtrain._LOSSES[loss]

        def fn(p, b):
            return base(p, b, 0.01, shape, 2.0, (0, 0, 0, 0))

    jwp.set_warp_differentiable(True)
    try:
        (val, _), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jwp.set_warp_differentiable(False)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grads(jparams, batch, loss, dtype=torch.float32):
    """The port's loss and gradients (JAX layouts) in `dtype`."""
    kind = "intra_ss" if loss == "intra" else "lssvc"
    params = {k: v.to(dtype) for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, kind).items()}
    fn = ttrain.make_loss_fn(0.01, (CROP, CROP), loss=loss,
                             cascade_warm=1 if loss == "cascade" else 0)
    with tnn.precision_scope(tnn.Mode("fp32")):
        val, _, grads = ttrain.value_and_grad(
            fn, params, {k: torch.from_numpy(v).to(dtype)
                         for k, v in batch.items()})
    return float(val), params_to_jax({k: g.float() for k, g in grads.items()},
                                     kind)


# Per-key bounds on the relative L2 distance of the port's float32 gradient
# from JAX's, and on the whole gradient's (all keys as one vector).
KEY_BOUND = {"pair": 1e-1, "warp": 1e-1, "spynet": 1e-3, "intra": 1e-3}
WHOLE_BOUND = 1e-2


def check_loss_and_gradients(loss):
    """The loss within 1e-4 relative, a key whose JAX gradient is exactly 0
    exactly 0 in the port, each key's gradient within `KEY_BOUND` relative
    L2 of JAX's and the whole gradient within `WHOLE_BOUND`; the worst key
    and the keys over 1e-3 are printed.

    `spynet` and `intra` hold every key to 1e-3.  Why not `pair` and
    `warp` (1e-1) and `cascade`: at random init many keys' float32
    gradients are sums that cancel to a small part of their terms, so their
    last digits are rounding.  The port's float32 gradient differs from its
    own float64 gradient by up to 0.98% relative L2 for `pair` (187 of 926
    keys over 1e-3), JAX's by up to 1.37%; a key of SpyNet's differs by
    0.27% between JAX and the port where every part of SpyNet (each
    level's convs, its warps, the upsampling) agrees to 5e-7 alone; and
    `warp`'s worst key (`weight_map_generator.generator3.2.bias`, a
    softmax logit's bias, whose gradient sums to nearly 0) differs from
    JAX's by 1.5% with 8 CPU threads and 3.2% with 1, the summation order
    alone.  A wrong formula (a tie's factor of 2, a missing term) moves a
    key by far more than 1e-1 and the whole gradient by more than 1e-2.  For
    `cascade` the warm frame reconstructs values of 1e4 and the port's own
    float32 and float64 gradients differ by up to 57% on a key, so its keys
    are held only as one vector."""
    jparams = (j_init_intra_ss(seed=0) if loss == "intra"
               else j_init_lssvc(seed=0))
    batch = _batch(loss)
    val_j, grads_j = _jax_loss_and_grads(jparams, batch, loss)
    val_t, got = _port_loss_and_grads(jparams, batch, loss)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-4)
    assert set(got) == set(grads_j)
    rel, zero = {}, []
    for k, r in grads_j.items():
        assert got[k].shape == r.shape, k
        if not np.any(r):
            zero.append(k)
            assert not np.any(got[k]), f"{k}: JAX's gradient is 0, the port's not"
            continue
        rel[k] = float(np.linalg.norm(got[k] - r) / np.linalg.norm(r))
    keys = sorted(grads_j)
    whole = float(np.linalg.norm(np.concatenate(
        [(got[k] - grads_j[k]).ravel() for k in keys])) / np.linalg.norm(
        np.concatenate([grads_j[k].ravel() for k in keys])))
    worst = max(rel, key=rel.get)
    over = sorted(k for k, v in rel.items() if v > 1e-3)
    print(f"{loss}: worst gradient {worst} at relative L2 {rel[worst]:.3g}; "
          f"whole gradient {whole:.3g}; {len(over)} of {len(rel)} keys over "
          f"1e-3; {len(zero)} keys exactly 0")
    assert whole <= WHOLE_BOUND, f"whole gradient: relative L2 {whole:.3g}"
    if loss in KEY_BOUND:
        bad = {k: v for k, v in rel.items() if v > KEY_BOUND[loss]}
        assert not bad, f"beyond {KEY_BOUND[loss]}: {bad}"


@pytest.mark.parametrize("loss", ["pair", "warp"])
def test_loss_and_gradients_match_jax(loss):
    check_loss_and_gradients(loss)
