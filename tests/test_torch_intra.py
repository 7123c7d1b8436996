"""The port's I-frame pair against the JAX package's.

The image-side entropy models (Gaussian conditional, EntropyBottleneck),
the three residual blocks of the intra codecs, `IntraNoAR.forward` at
64x64 (N=192) and `IntraSS.forward` at EL 128x128 / BL 64x64 (full widths:
BL 192, EL 64/96), fp32.  Weights are the JAX package's `init_intra_ss(192)`
bridged by `params_from_jax`.  Entropy models within 1e-5 relative; bits
within 3e-3 relative; reconstructions, latents and features within the 5%
relative-RMS noise floor of tests/parity_utils.py (random-init latents
are large, so a near-tie rounding can flip between the two frameworks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parity_utils import assert_rel_rms
from lssvc_tpu.convert import P as JP
from lssvc_tpu.entropy import models as jent
from lssvc_tpu.models import components as jcomp
from lssvc_tpu.models import intra_noar as jin
from lssvc_tpu.models import intra_ss as jis
from lssvc_tpu.models.init import Builder, Rng
from lssvc_tpu.models.init import init_intra_noar as j_init_intra_noar
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu_torch.convert import P as TP
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.entropy import models as tent
from lssvc_tpu_torch.models import IntraNoAR, IntraSS
from lssvc_tpu_torch.models import components as tcomp
from lssvc_tpu_torch.models.init import init_intra_noar, init_intra_ss

BL_PREFIX = "base_layer_model."


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _max_rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)))


def _close_bits(a, b, rel=3e-3):
    a, b = float(a), float(b)
    assert abs(a - b) <= rel * max(abs(b), 1.0), (a, b)


@pytest.fixture(scope="module")
def ss_params():
    """The JAX package's IntraSS init (BL 192) and its bridged twin."""
    jparams = j_init_intra_ss(192)
    return jparams, params_from_jax(_np(jparams), "intra_ss")


@pytest.mark.parametrize("with_means", [True, False])
def test_gaussian_conditional_likelihood(rng, with_means):
    shape = (1, 6, 5, 16)
    y = (rng.normal(size=shape) * 4).astype(np.float32)
    # scales below the 0.11 bound, and tails past the 1e-9 likelihood bound
    scales = np.abs(rng.normal(size=shape) * 3).astype(np.float32)
    scales[0, 0, 0, :4] = 0.01
    y[0, 1, 1, :4] = 80.0
    means = (rng.normal(size=shape) * 2).astype(np.float32) if with_means \
        else None
    ref = jent.gaussian_conditional_likelihood(
        jnp.asarray(y), jnp.asarray(scales),
        None if means is None else jnp.asarray(means))
    out = tent.gaussian_conditional_likelihood(
        torch.from_numpy(y), torch.from_numpy(scales),
        None if means is None else torch.from_numpy(means))
    assert float(np.min(np.asarray(ref))) == pytest.approx(1e-9)
    assert _max_rel(out.numpy(), ref) <= 1e-5


def test_entropy_bottleneck_forward(rng):
    c = 16
    b = Builder(Rng(0))
    b.entropy_bottleneck("eb", c)
    jp = _np(b.d)
    # move the medians and give the factors weight, so every term counts
    jp["eb.quantiles"] = jp["eb.quantiles"] + rng.normal(
        size=(c, 1, 1)).astype(np.float32)
    for i in range(4):
        jp[f"eb._factors.{i}"] = rng.normal(
            size=jp[f"eb._factors.{i}"].shape).astype(np.float32)
    for i in range(5):
        jp[f"eb._matrices.{i}"] = jp[f"eb._matrices.{i}"] + 0.3 * rng.normal(
            size=jp[f"eb._matrices.{i}"].shape).astype(np.float32)
    z = (rng.normal(size=(1, 4, 6, c)) * 6).astype(np.float32)
    jscope = JP({k: jnp.asarray(v) for k, v in jp.items()}).sub("eb")
    tp = TP(params_from_jax(jp, "intra_noar")).sub("eb")
    x_ref, lik_ref = jent.entropy_bottleneck_forward(jscope, jnp.asarray(z))
    x_out, lik_out = tent.entropy_bottleneck_forward(tp, torch.from_numpy(z))
    np.testing.assert_array_equal(x_out.numpy(), np.asarray(x_ref))
    # the logits within 1e-5 of their largest magnitude (they cross zero);
    # the likelihood is a difference of two sigmoids of them (each <= 1),
    # so its error is held to 1e-6 absolute: relative to a small
    # difference, one ulp of the terms is more than 1e-5
    v = z.transpose(3, 0, 1, 2).reshape(c, 1, -1)
    ref = np.asarray(jent.entropy_bottleneck_logits(jscope, jnp.asarray(v)))
    out = tent.entropy_bottleneck_logits(tp, torch.from_numpy(v)).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))
    assert np.max(np.abs(lik_out.numpy() - np.asarray(lik_ref))) <= 1e-6
    assert float(np.min(np.asarray(lik_ref))) >= 1e-9


@pytest.mark.parametrize("block,cin,cout,stride", [
    ("residual_block", 16, 16, 1),
    ("residual_block_with_stride", 8, 16, 2),
    ("residual_block_with_stride", 16, 16, 1),
    ("residual_block_upsample", 16, 8, 2),
])
def test_residual_blocks(rng, block, cin, cout, stride):
    b = Builder(Rng(1))
    if block == "residual_block_with_stride":
        b.residual_block_with_stride("blk", cin, cout, stride=stride)
        kw = {"stride": stride}
    else:
        getattr(b, block)("blk", cin, cout)
        kw = {}
    jp = _np(b.d)
    assert ("blk.downsample.weight" in jp) == (
        block == "residual_block_with_stride" and stride == 2)
    x = rng.normal(size=(1, 12, 10, cin)).astype(np.float32)
    ref = np.asarray(getattr(jcomp, block)(
        JP({k: jnp.asarray(v) for k, v in jp.items()}).sub("blk"),
        jnp.asarray(x), **kw))
    out = getattr(tcomp, block)(TP(params_from_jax(jp, "intra_noar")).sub("blk"),
                                torch.from_numpy(x), **kw).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_intra_noar_forward_matches_jax(ss_params, rng):
    jparams, tparams = ss_params
    jbl = {k[len(BL_PREFIX):]: v for k, v in jparams.items()
           if k.startswith(BL_PREFIX)}
    tbl = {k[len(BL_PREFIX):]: v for k, v in tparams.items()
           if k.startswith(BL_PREFIX)}
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    ref = jin._forward_jit(jbl, jnp.asarray(x))
    model = IntraNoAR(tbl, device="cpu")
    assert model.N == 192
    out = model.forward(torch.from_numpy(x))
    _close_bits(out["bit"], ref["bit"])
    for k in ("x_hat", "y_hat", "z_hat", "scales_hat", "means_hat"):
        assert_rel_rms(out[k].numpy(), np.asarray(ref[k]))
    info = model.get_layer_information(torch.from_numpy(x))
    _close_bits(info["bpp"] * 64 * 64, ref["bit"])
    assert float(info["mse"]) == pytest.approx(
        float(np.mean((x - np.asarray(ref["x_hat"])) ** 2)), rel=0.05)


@pytest.mark.parametrize("bl_hw,pad", [((64, 64), (0, 0, 0, 0)),
                                       ((128, 64), (0, 0, 0, -64))])
def test_intra_ss_forward_matches_jax(ss_params, rng, bl_hw, pad):
    """Zero pad, and a negative pad that crops the BL 128x64 -> 64x64
    before context mining (`tests/test_intra_ss.py:54`)."""
    jparams, tparams = ss_params
    x_el = rng.random((1, 128, 128, 3), dtype=np.float32)
    x_bl = rng.random((1, *bl_hw, 3), dtype=np.float32)
    ref = jis.forward(jparams, jnp.asarray(x_bl), jnp.asarray(x_el),
                      (128, 128), pad)
    model = IntraSS(tparams, device="cpu")
    model.set_scale_information(2.0, (128, 128), pad)
    out = model.forward(torch.from_numpy(x_bl), torch.from_numpy(x_el))
    for k in ("bit_bl", "bit_el"):
        _close_bits(out[k], ref[k])
    for k in ("x_hat_bl", "x_hat_el", "y_hat_el", "feature_el"):
        assert_rel_rms(out[k].numpy(), np.asarray(ref[k]))
    assert out["feature_el"].shape == (1, 128, 128, 64)
    with pytest.raises(NotImplementedError, match="RDO"):
        model.forward(torch.from_numpy(x_bl), torch.from_numpy(x_el),
                      rdo=True)


def test_bridged_init_loads_strict(ss_params):
    """The bridged JAX init loads strict into both I-frame models, and
    their state_dicts carry the reference's keys."""
    jparams, tparams = ss_params
    model = IntraSS(tparams, device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(jparams)
    model.load_state_dict(params_from_jax(_np(jparams), "intra_ss"),
                          strict=True)
    assert all(sd[k].numel() == np.asarray(jparams[k]).size for k in sd)
    bl = {k[len(BL_PREFIX):]: v for k, v in jparams.items()
          if k.startswith(BL_PREFIX)}
    noar = IntraNoAR(params_from_jax(_np(bl), "intra_noar"), device="cpu")
    noar.load_state_dict(params_from_jax(_np(bl), "intra_noar"), strict=True)


@pytest.mark.parametrize("which", ["intra_noar", "intra_ss"])
def test_own_init_matches_keys_and_shapes(ss_params, which):
    jparams, tparams = ss_params
    gen = torch.Generator().manual_seed(0)
    if which == "intra_ss":
        mine, ref = init_intra_ss(gen, 192), tparams
    else:
        mine = init_intra_noar(gen, 32)
        ref = params_from_jax(_np(j_init_intra_noar(32)), "intra_noar")
    assert set(mine) == set(ref)
    wrong = [k for k in ref if tuple(mine[k].shape) != tuple(ref[k].shape)]
    assert not wrong, wrong
    assert all(v.dtype == torch.float32 for v in mine.values())
