"""The port's base layer and OffsetDiversity against the JAX package's.

`dmc.forward_inter` at BL 64x64, full channel widths, fp32, with a
64-channel reference feature and with None; `offset_diversity` with the
offset cap off and at 10 px, on inputs scaled so that offsets exceed it.
Weights are the JAX package's random init, bridged by `params_from_jax`.
Bits within 3e-3 relative; reconstructions within the 5% relative-RMS
noise floor of tests/parity_utils.py (round-tie flips in the quantised
latents of a random-init codec spread through its decoders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_close_mostly, assert_rel_rms
from lssvc_tpu.convert import P as JP
from lssvc_tpu.models import dmc as jdmc
from lssvc_tpu.models.init import init_dmc
from lssvc_tpu.models.lssvc_blocks import offset_diversity as j_od
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch.convert import P as TP
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models import DMC
from lssvc_tpu_torch.models.lssvc_blocks import offset_diversity as t_od

from torch_threads import share_cores

share_cores()


@pytest.fixture(scope="module")
def dmc_pair():
    jparams = init_dmc(0)
    model = DMC(params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                "dmc"),
                device="cpu")
    return jparams, model


def test_bridged_init_loads_strict(dmc_pair):
    jparams, model = dmc_pair
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    assert set(model.state_dict()) == set(np_params)
    model.load_state_dict(params_from_jax(np_params, "dmc"), strict=True)


def _bits_close(port, ref, rel=3e-3):
    port, ref = float(port), float(ref)
    assert abs(port - ref) <= rel * max(abs(ref), 1.0), (port, ref)


@pytest.mark.parametrize("with_feature", [True, False])
def test_forward_inter_matches_jax(dmc_pair, with_feature):
    jparams, model = dmc_pair
    rng = np.random.default_rng(3 + with_feature)
    x, ref = (rng.random((1, 64, 64, 3), np.float32) for _ in range(2))
    feat = rng.random((1, 64, 64, 64), np.float32) if with_feature else None

    j = jdmc._forward_inter_jit(
        jparams, jnp.asarray(x), jnp.asarray(ref),
        None if feat is None else jnp.asarray(feat))
    t = model.forward_inter(torch.from_numpy(x), torch.from_numpy(ref),
                            None if feat is None else torch.from_numpy(feat))

    _bits_close(t["bits"], j["bits"])
    assert_rel_rms(t["recon_image"].numpy(), j["recon_image"])
    assert_rel_rms(t["feature"].numpy(), j["feature"])
    assert_close_mostly(t["mv_hat"].numpy(), j["mv_hat"])
    assert_close_mostly(t["warp_frame"].numpy(), j["warp_frame"])


def _od_params(rng):
    """OffsetDiversity weights in the JAX layout, with a non-zero offset
    head (the init's is zero, an identity warp)."""
    def w(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)
    return {
        "conv_offset.0.weight": w(3, 3, 53, 64), "conv_offset.0.bias": w(64),
        "conv_offset.2.weight": w(3, 3, 64, 64), "conv_offset.2.bias": w(64),
        "conv_offset.4.weight": w(3, 3, 64, 96), "conv_offset.4.bias": w(96),
        "fusion.weight": w(1, 1, 6, 48), "fusion.bias": w(48),
    }


@pytest.mark.parametrize("cap", [None, 10.0])
def test_offset_diversity_matches_jax(cap):
    rng = np.random.default_rng(5)
    jp = _od_params(rng)
    x = rng.normal(size=(1, 16, 24, 48)).astype(np.float32)
    aux = (rng.normal(size=(1, 16, 24, 53)) * 30).astype(np.float32)
    flow = rng.normal(size=(1, 16, 24, 2)).astype(np.float32)

    # the JAX cap is a trace-time global: set it explicitly on both sides
    set_od_offset_cap(cap)
    jax.clear_caches()
    try:
        ref = np.asarray(j_od(JP({k: jnp.asarray(v) for k, v in jp.items()}),
                              jnp.asarray(x), jnp.asarray(aux),
                              jnp.asarray(flow)))
    finally:
        set_od_offset_cap(None)
        jax.clear_caches()
    tp = TP(params_from_jax(jp, "lssvc"))
    out = t_od(tp, torch.from_numpy(x), torch.from_numpy(aux),
               torch.from_numpy(flow), offset_cap=cap).numpy()
    assert_close_mostly(out, ref)

    # the inputs drive offsets past the cap, so the cap changes the output
    other = t_od(tp, torch.from_numpy(x), torch.from_numpy(aux),
                 torch.from_numpy(flow),
                 offset_cap=None if cap else 10.0).numpy()
    assert not np.allclose(out, other, atol=1e-3)
