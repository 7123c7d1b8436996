"""The port's latent RDO (`lssvc_tpu_torch/models/rdo.py`) against the JAX
package's, at the JAX test's size (`tests/test_rdo.py`: IntraNoAR N=32 on a
64x64 image from seed 3).

The refinement is chaotic (an element near the threshold moves or not on
the last bit of its gradient), so the port is held to JAX step by step:
the same (y, z) give the same loss (rtol 1e-5) and gradients (relative RMS
<= 1e-4); the same (v, grad) give the same update, bit for bit.  Whole runs
are held to the invariants `tests/test_rdo.py` holds.  Each image-side
entropy function on the path is differentiated by both frameworks with its
inputs on the lower bounds (ties included), where `torch.clamp` and
`jnp.maximum` would split the gradient differently.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_rel_rms
from lssvc_tpu.convert import P as JP
from lssvc_tpu.entropy import models as jent
from lssvc_tpu.models import intra_ss as jis
from lssvc_tpu.models import rdo as jrdo
from lssvc_tpu.models.init import init_intra_noar as j_init_intra_noar
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.intra_noar import analysis as j_analysis
from lssvc_tpu_torch.convert import P as TP
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.entropy import models as tent
from lssvc_tpu_torch.models import IntraNoAR, IntraSS
from lssvc_tpu_torch.models import intra_ss as tis
from lssvc_tpu_torch.models import rdo as trdo

from torch_threads import share_cores

share_cores()

RDO_OPT = {"lmbda": 0.01, "max_iter": 25, "iter_to_exit": 6,
           "iter_to_reduce": 3}
BL_PREFIX = "base_layer_model."


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def noar():
    """The JAX test's IntraNoAR (N=32) and its bridged twin, its image and
    the JAX analysis latents."""
    jparams = j_init_intra_noar(N=32)
    x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    y, z = j_analysis(jparams, jnp.asarray(x))
    model = IntraNoAR(params_from_jax(_np(jparams), "intra_noar"),
                      device="cpu")
    return jparams, model, x, np.asarray(y), np.asarray(z)


def test_loss_and_grads_match_jax(noar):
    jparams, model, x, y, z = noar
    loss_j, gy_j, gz_j = jrdo._loss_and_grads(
        jparams, jnp.asarray(y), jnp.asarray(z), jnp.asarray(x), 0.01)
    with torch.no_grad():  # as under a model's entry point
        loss_t, gy_t, gz_t = trdo._loss_and_grads(
            model.flat_params(), torch.from_numpy(y), torch.from_numpy(z),
            torch.from_numpy(x), 0.01)
    assert not (gy_t.requires_grad or loss_t.requires_grad)
    assert all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert_rel_rms(gy_t.numpy(), np.asarray(gy_j), 1e-4)
    assert_rel_rms(gz_t.numpy(), np.asarray(gz_j), 1e-4)


@pytest.mark.parametrize("stage", range(3))
def test_masked_update_is_bit_equal_to_jax(noar, stage):
    """The same (v, grad) give the same update at each stage's thresholds
    and steps, for y and z, and an all-zero gradient leaves v as it is."""
    jparams, _, x, y, z = noar
    _, gy, gz = jrdo._loss_and_grads(jparams, jnp.asarray(y), jnp.asarray(z),
                                     jnp.asarray(x), 0.01)
    ty, sy, tz, sz = trdo.STAGES[stage]
    cases = [(y, np.asarray(gy), ty, sy), (z, np.asarray(gz), tz, sz),
             (y, np.zeros_like(y), ty, sy)]
    for v, g, t, s in cases:
        ref = np.asarray(jrdo._masked_update(jnp.asarray(v), jnp.asarray(g),
                                             t, s))
        out = trdo._masked_update(torch.from_numpy(v), torch.from_numpy(g),
                                  t, s).numpy()
        np.testing.assert_array_equal(out, ref)
        assert np.array_equal(out, v) == (not g.any())


def test_bits_rdo_strictly_reduces_rd_loss(noar):
    _, model, x, _, _ = noar
    params = model.flat_params()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, z = model.get_y_z(xt)
        loss0 = float(trdo._rd_loss(params, y, z, xt, RDO_OPT["lmbda"]))
        trace = []
        best_y, best_z, best_loss = trdo.bits_rdo(
            params, y, z, xt, RDO_OPT["lmbda"], max_iter=RDO_OPT["max_iter"],
            iter_to_exit=RDO_OPT["iter_to_exit"],
            iter_to_reduce=RDO_OPT["iter_to_reduce"], trace=trace)
        re_loss = float(trdo._rd_loss(params, best_y, best_z, xt,
                                      RDO_OPT["lmbda"]))
    assert best_loss < loss0, (best_loss, loss0)
    assert float(torch.max(torch.abs(best_y - y))) > 0
    np.testing.assert_allclose(re_loss, best_loss, rtol=1e-6)
    # one loss a iteration: the first at the analysis latents, the best
    # among them
    assert 1 < len(trace) <= RDO_OPT["max_iter"]
    assert trace[0][0] == pytest.approx(loss0, rel=1e-6)
    assert min(t[0] for t in trace) == best_loss


def test_rdo_stream_decodes_to_the_estimated_path(noar, tmp_path):
    """encode_decode(rdo=True) with and without a stream code the same
    refined latents (bits_rdo is deterministic): the bins decode to the
    estimated path's reconstruction bit for bit, the real bits track the
    estimate, and the RD cost beats coding the analysis latents."""
    _, model, x, _, _ = noar
    xt = torch.from_numpy(x)
    model.update(force=True)
    est = model.encode_decode(xt, rdo=True, rdo_opt=RDO_OPT)
    res = model.encode_decode(xt, tmp_path / "rdo.bin", 64, 64, rdo=True,
                              rdo_opt=RDO_OPT)
    assert torch.equal(res["x_hat"], est["x_hat"])
    assert torch.equal(res["y_hat"], est["y_hat"])
    overhead = 16 * 8 + 2 * 2 * 64
    assert abs(res["bit"] - est["bit"]) < overhead + 0.1 * est["bit"]

    lam = RDO_OPT["lmbda"]

    def rd_cost(r):
        mse = float(torch.mean(torch.square(r["x_hat"] - xt)))
        return lam * 255.0 ** 2 * mse + r["bit"] / (64 * 64)

    base = model.encode_decode(xt, tmp_path / "base.bin", 64, 64)
    assert rd_cost(res) < rd_cost(base), (rd_cost(res), rd_cost(base))


def test_intra_ss_forward_from_bl_latents_matches_jax():
    """Both layers from the same BL latents (JAX's analysis latents moved
    off the grid, as RDO leaves them) against the JAX program, and
    `IntraSS.forward(rdo=True)` runs the optimizer and leaves the BL's RD
    cost no worse."""
    jparams = j_init_intra_ss(channel_BL=32)
    tparams = params_from_jax(_np(jparams), "intra_ss")
    rng = np.random.default_rng(5)
    x_bl = rng.random((1, 64, 64, 3)).astype(np.float32)
    x_el = rng.random((1, 128, 128, 3)).astype(np.float32)
    blp = {k[len(BL_PREFIX):]: v for k, v in jparams.items()
           if k.startswith(BL_PREFIX)}
    y, z = (np.asarray(t) for t in j_analysis(blp, jnp.asarray(x_bl)))
    y = y + rng.normal(size=y.shape).astype(np.float32) * 0.3
    ref = jis.forward_from_bl_latents(jparams, jnp.asarray(x_el),
                                      jnp.asarray(y), jnp.asarray(z), None,
                                      (128, 128), (0, 0, 0, 0))
    model = IntraSS(tparams, device="cpu")
    model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    with torch.no_grad():
        out = tis.forward_from_bl_latents(
            model.el_params(), model.base_layer_model.flat_params(),
            torch.from_numpy(x_el), torch.from_numpy(y), torch.from_numpy(z),
            (128, 128), (0, 0, 0, 0))
    for k in ("bit_bl", "bit_el"):
        assert float(out[k]) == pytest.approx(float(ref[k]), rel=3e-3)
    for k in ("x_hat_bl", "x_hat_el", "y_hat_el", "feature_el"):
        assert_rel_rms(out[k].numpy(), np.asarray(ref[k]))

    xb, xe = torch.from_numpy(x_bl), torch.from_numpy(x_el)
    rdo_out = model.forward(xb, xe, rdo=True, rdo_opt=RDO_OPT)
    base = model.forward(xb, xe)

    def bl_cost(o):
        mse = float(torch.mean(torch.square(o["x_hat_bl"] - xb)))
        return 0.01 * 255.0 ** 2 * mse + float(o["bit_bl"]) / (64 * 64)

    assert np.isfinite(float(rdo_out["bit_el"]))
    assert bl_cost(rdo_out) <= bl_cost(base) + 1e-6


def _grads_both(j_fn, t_fn, arrays, cot):
    """d(sum(f(*arrays) * cot)) / d arrays, by jax.grad and by autograd."""
    def j_loss(*a):
        return jnp.sum(j_fn(*a) * cot)

    j_g = jax.grad(j_loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    t_g = torch.autograd.grad(torch.sum(t_fn(*ts) * torch.from_numpy(cot)),
                              ts)
    return [np.asarray(g) for g in j_g], [g.numpy() for g in t_g]


def test_gaussian_conditional_gradients_match_jax_at_the_bounds():
    """Scales on the 0.11 bound and below it, inputs equal to their means
    (|0|), tails under the 1e-9 bound, and a likelihood bound equal to one
    element's likelihood (each framework's own value, so both tie)."""
    rng = np.random.default_rng(7)
    shape = (1, 4, 5, 8)
    means = (rng.normal(size=shape) * 2).astype(np.float32)
    y = means + (rng.normal(size=shape) * 0.8).astype(np.float32)
    scales = np.abs(rng.normal(size=shape) * 2).astype(np.float32) + 0.2
    scales[0, 0, :, :3] = np.float32(0.11)   # ties with the scale bound
    y[0, 0, :, :3] = means[0, 0, :, :3] + 0.1  # inside the bin there
    scales[0, 1, :, :3] = np.float32(0.05)   # below it
    y[0, 2, :, :4] = means[0, 2, :, :4]      # |y - means| at 0
    y[0, 3, 0, :2] = means[0, 3, 0, :2] + 40.0  # tails below 1e-9
    cot = rng.normal(size=shape).astype(np.float32)
    arrays = [y, scales, means]
    tie_j = float(np.asarray(jent.gaussian_conditional_likelihood(
        *[jnp.asarray(a) for a in arrays], likelihood_bound=0.0))[0, 3, 4, 5])
    tie_t = float(tent.gaussian_conditional_likelihood(
        *[torch.from_numpy(a) for a in arrays],
        likelihood_bound=0.0)[0, 3, 4, 5])
    for bj, bt in ((1e-9, 1e-9), (tie_j, tie_t)):
        j_g, t_g = _grads_both(
            lambda a, s, m: jent.gaussian_conditional_likelihood(
                a, s, m, likelihood_bound=bj),
            lambda a, s, m: tent.gaussian_conditional_likelihood(
                a, s, m, likelihood_bound=bt),
            arrays, cot)
        for jg, tg in zip(j_g, t_g):
            np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
        # the scale ties pass a gradient (half of it), the scales below the
        # bound none
        assert np.all(t_g[1][0, 0, :, :3] != 0)
        assert np.all(t_g[1][0, 1, :, :3] == 0)
    assert t_g[0][0, 3, 4, 5] != 0  # the likelihood tie passes half


def test_entropy_bottleneck_gradients_match_jax_at_the_bounds():
    """The straight-through round, sign (no gradient) and |.| of the
    EntropyBottleneck, values far in the tails (the 1e-9 bound), and a
    likelihood bound equal to one element's likelihood (each framework's
    own value, so both tie)."""
    rng = np.random.default_rng(8)
    c = 8
    jp = _np({k: v for k, v in j_init_intra_noar(N=c).items()
              if k.startswith("entropy_bottleneck.")})
    for i in range(4):
        jp[f"entropy_bottleneck._factors.{i}"] = rng.normal(
            size=jp[f"entropy_bottleneck._factors.{i}"].shape) \
            .astype(np.float32)
    z = (rng.normal(size=(1, 3, 4, c)) * 5).astype(np.float32)
    z[0, 0, 0, :2] = 3000.0
    cot = rng.normal(size=z.shape).astype(np.float32)
    jscope = JP({k: jnp.asarray(v) for k, v in jp.items()}) \
        .sub("entropy_bottleneck")
    tscope = TP(params_from_jax(jp, "intra_noar")).sub("entropy_bottleneck")
    tie_j = float(np.asarray(jent.entropy_bottleneck_forward(
        jscope, jnp.asarray(z), likelihood_bound=0.0)[1])[0, 1, 2, 3])
    tie_t = float(tent.entropy_bottleneck_forward(
        tscope, torch.from_numpy(z), likelihood_bound=0.0)[1][0, 1, 2, 3])
    for bj, bt in ((1e-9, 1e-9), (tie_j, tie_t)):
        j_g, t_g = _grads_both(
            lambda a: jent.entropy_bottleneck_forward(
                jscope, a, likelihood_bound=bj)[1],
            lambda a: tent.entropy_bottleneck_forward(
                tscope, a, likelihood_bound=bt)[1],
            [z], cot)
        np.testing.assert_allclose(t_g[0], j_g[0], rtol=1e-5, atol=1e-7)
        assert np.all(t_g[0][0, 0, 0, :2] == 0)  # under the bound
    assert t_g[0][0, 1, 2, 3] != 0  # the tie passes half
    # x_hat passes the gradient straight through the round
    j_g, t_g = _grads_both(
        lambda a: jent.entropy_bottleneck_forward(jscope, a)[0],
        lambda a: tent.entropy_bottleneck_forward(tscope, a)[0], [z], cot)
    np.testing.assert_array_equal(t_g[0], j_g[0])
    np.testing.assert_array_equal(t_g[0], cot)
