"""The port's two-layer P-frame forward against the JAX package's.

The whole slice: `forward_one_frame` (BL DMC + EL LSSVC, estimated bits) at
EL 128x128 / BL 64x64, full channel widths, fp32, the OffsetDiversity cap at
the serving 10 px on both sides.  Weights are the JAX package's
`init_lssvc(0)`, bridged by `params_from_jax`.  Bits within 3e-3 relative;
reconstructions and features within the 5% relative-RMS noise floor of
tests/parity_utils.py; `mv_hat` through `assert_close_mostly`.  Last, the
port's CLI with `LSSVC_OD_OFFSET_CAP=0` against the JAX package at cap 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_close_mostly, assert_rel_rms
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models.init import init_intra_ss as t_init_intra_ss
from lssvc_tpu_torch.models.init import init_lssvc as t_init_lssvc
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops.nn import od_offset_cap_from_env
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.tools.synthetic import write_dataset

EL, BL = (128, 128), (64, 64)
DPB_KEYS = ("ref_frame_bl", "ref_frame_el", "ref_feature_bl",
            "ref_feature_el")


@pytest.fixture(scope="module")
def pair():
    jparams = j_init_lssvc(0)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    model = LSSVC(params_from_jax(np_params, "lssvc"), device="cpu",
                  od_offset_cap=OD_OFFSET_CAP_SERVING)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)  # read when JAX traces
    jax.clear_caches()
    yield jparams, np_params, model
    set_od_offset_cap(None)
    jax.clear_caches()


def _jax_frame(jparams, x_bl, x_el, dpb):
    return jl._fwd_jit(jparams, jnp.asarray(x_bl), jnp.asarray(x_el),
                       *(jnp.asarray(dpb[k]) for k in DPB_KEYS),
                       EL, 2.0, (0, 0, 0, 0))


def _port_frame(model, x_bl, x_el, dpb):
    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.from_numpy(v)

    return model.forward_one_frame(t(x_bl), t(x_el),
                                   *(t(dpb[k]) for k in DPB_KEYS))


def _inputs(seed, el_feature_ch):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    x_bl, x_el = a(*BL, 3), a(*EL, 3)
    dpb = {"ref_frame_bl": a(*BL, 3), "ref_frame_el": a(*EL, 3),
           "ref_feature_bl": a(*BL, 64),
           "ref_feature_el": a(*EL, el_feature_ch)}
    return x_bl, x_el, dpb


def _assert_frame_close(t, j):
    for k in ("bit_bl", "bit_el"):
        port, ref = float(t[k]), float(j[k])
        assert abs(port - ref) <= 3e-3 * max(abs(ref), 1.0), (k, port, ref)
    for k in DPB_KEYS:
        assert_rel_rms(t["dpb"][k].numpy(), j["dpb"][k])
    assert_close_mostly(t["mv_hat"].numpy(), j["mv_hat"])


def test_bridged_init_loads_strict(pair):
    _, np_params, model = pair
    sd = model.state_dict()
    assert set(sd) == set(np_params)
    model.load_state_dict(params_from_jax(np_params, "lssvc"), strict=True)
    assert all(sd[k].numel() == np_params[k].size for k in sd)


def test_own_init_matches_keys_and_shapes(pair):
    _, _, model = pair
    own = t_init_lssvc(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(own) == set(sd)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("el_feature_ch", [48, 64],
                         ids=["steady_state", "first_p"])
def test_forward_one_frame_matches_jax(pair, el_feature_ch):
    jparams, _, model = pair
    x_bl, x_el, dpb = _inputs(11 + el_feature_ch, el_feature_ch)
    _assert_frame_close(_port_frame(model, x_bl, x_el, dpb),
                        _jax_frame(jparams, x_bl, x_el, dpb))


def test_dpb_chain_three_frames(pair):
    """Three frames, each side feeding its own decoded-picture buffer back,
    with the reference frames clamped to [0, 1] between frames as the
    codec's GOP loop does (lssvc_tpu/harness/runner.py:185-190, the
    reference's test.py:249-250).  Unclamped, a random-init codec's reconstructions
    reach ~1e4 by the third frame, where the JAX package's own jit and
    eager forwards already differ by 4.5% relative RMS in mv_hat."""
    jparams, _, model = pair
    x_bl, x_el, dpb = _inputs(7, 48)
    rng = np.random.default_rng(8)
    frames = [(x_bl, x_el)] + [
        (rng.random((1, *BL, 3), np.float32),
         rng.random((1, *EL, 3), np.float32)) for _ in range(2)]
    dpb_j, dpb_t = dpb, dpb
    for xb, xe in frames:
        j = _jax_frame(jparams, xb, xe, dpb_j)
        t = _port_frame(model, xb, xe, dpb_t)
        _assert_frame_close(t, j)
        dpb_j = {k: np.array(v) for k, v in j["dpb"].items()}
        dpb_t = dict(t["dpb"])
        for k in ("ref_frame_bl", "ref_frame_el"):
            dpb_j[k] = np.clip(dpb_j[k], 0, 1)
            dpb_t[k] = torch.clamp(dpb_t[k], 0, 1)


def test_cli_reads_the_offset_cap_from_the_environment(pair, tmp_path,
                                                       monkeypatch):
    """`LSSVC_OD_OFFSET_CAP=0` turns the cap off, as in the JAX package's
    CLI: the port's CLI loads its LSSVC with `od_offset_cap is None`, and a
    P-frame of that model matches the JAX package at cap 0.  The offset
    head is given weights (the init's are zero, an identity warp) that
    drive offsets past 10 px, so the cap changes the frame.  (Last in the
    module: it compiles the JAX forward at cap 0, then restores the
    module's cap.)"""
    _, np_params, _ = pair
    rng = np.random.default_rng(3)
    np_params = dict(np_params)
    for k in ("align.conv_offset.4.weight", "align.conv_offset.4.bias"):
        np_params[k] = rng.normal(size=np_params[k].shape).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    ckpt = tmp_path / "video.pth"
    torch.save(params_from_jax(np_params, "lssvc"), ckpt)
    intra = tmp_path / "intra.pth"
    torch.save(t_init_intra_ss(torch.Generator().manual_seed(0), 32), intra)
    cfg = write_dataset(tmp_path / "ds", 64, 64, frames=1, gop=1, seed=0)
    loaded = []

    def no_run(video_net, i_frame_net, task):  # the loaded models only
        loaded.append(video_net)
        return {}, {}, {}

    monkeypatch.setattr(scheduler, "run_test", no_run)
    monkeypatch.setenv("LSSVC_OD_OFFSET_CAP", "0")
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", str(intra),
              "--model_path", str(ckpt), "--output_path",
              str(tmp_path / "out"), "--ratios", "x2", "--device", "cpu"])
    model, = loaded
    assert model.od_offset_cap is None
    for value, cap in (("", None), ("12.5", 12.5)):
        monkeypatch.setenv("LSSVC_OD_OFFSET_CAP", value)
        assert od_offset_cap_from_env() == cap
    monkeypatch.delenv("LSSVC_OD_OFFSET_CAP")
    assert od_offset_cap_from_env() == OD_OFFSET_CAP_SERVING

    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    set_od_offset_cap(0)
    jax.clear_caches()
    try:
        x_bl, x_el, dpb = _inputs(21, 48)
        port = _port_frame(model, x_bl, x_el, dpb)
        _assert_frame_close(port, _jax_frame(jparams, x_bl, x_el, dpb))
        model.od_offset_cap = OD_OFFSET_CAP_SERVING
        capped = _port_frame(model, x_bl, x_el, dpb)["dpb"]["ref_frame_el"]
        assert not torch.allclose(capped, port["dpb"]["ref_frame_el"],
                                  atol=1e-3)
    finally:
        set_od_offset_cap(OD_OFFSET_CAP_SERVING)
        jax.clear_caches()
