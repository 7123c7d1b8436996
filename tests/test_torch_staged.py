"""The staged P-frame of the port (`forward_one_frame_staged3`: BL | EL
contexts | EL residual | EL recon, and `forward_one_frame_staged`: BL |
EL) against its fused `forward_one_frame` and against the JAX package's
staged functions of the same names.

EL 128x128 / BL 64x64, full widths, fp32, the OffsetDiversity cap at the
serving 10 px on both sides, weights from the JAX package's
`init_lssvc(0)` bridged by `params_from_jax`.  Against the fused frame:
the DPB bit for bit, the bits within 1e-6 relative (the staged frames are
the fused frame's calls in the port, so they agree exactly; the bound is
the one a regrouped bit sum would need).  Against the JAX package: bits within 3e-3
relative, the DPB within 5% relative RMS, as tests/test_torch_lssvc.py.
Last, int8: the staged frames serve the fused frame's sites, as often.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_rel_rms
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.harness.calibrate import calibrate_video
from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)
DPB_KEYS = ("ref_frame_bl", "ref_frame_el", "ref_feature_bl",
            "ref_feature_el")
STAGED = ("forward_one_frame_staged3", "forward_one_frame_staged")
# the keys of the JAX package's staged frames
OUT_KEYS = {"dpb", "bit_bl", "bit_el", "mv_hat", "warp_frame", "context"}


@pytest.fixture(scope="module")
def pair():
    jparams = j_init_lssvc(0)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "lssvc")
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)  # read when JAX traces
    jax.clear_caches()
    yield jparams, tparams
    set_od_offset_cap(None)
    jax.clear_caches()


def _model(tparams, **mode):
    model = LSSVC(tparams, device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING,
                  **mode)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    return model


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    return [a(*BL, 3), a(*EL, 3), a(*BL, 3), a(*EL, 3), a(*BL, 64),
            a(*EL, 48)]


def _port(model, name, inputs):
    return getattr(model, name)(*(torch.from_numpy(a) for a in inputs))


@pytest.fixture(scope="module")
def frames(pair):
    """name -> the port's frame on the same inputs, fused and staged."""
    model = _model(pair[1])
    inputs = _inputs(3)
    return inputs, {name: _port(model, name, inputs)
                    for name in ("forward_one_frame",) + STAGED}


@pytest.mark.parametrize("name", STAGED)
def test_staged_equals_fused(frames, name):
    _, outs = frames
    fused, staged = outs["forward_one_frame"], outs[name]
    assert set(staged) == OUT_KEYS
    for k in DPB_KEYS:
        assert torch.equal(staged["dpb"][k], fused["dpb"][k]), k
    for k in ("mv_hat", "warp_frame", "context"):
        assert torch.equal(staged[k], fused[k]), k
    assert torch.equal(staged["bit_bl"], fused["bit_bl"])
    port, ref = float(staged["bit_el"]), float(fused["bit_el"])
    assert abs(port - ref) <= 1e-6 * abs(ref), (port, ref)


@pytest.mark.parametrize("name", STAGED)
def test_staged_matches_jax(pair, frames, name):
    jparams, _ = pair
    inputs, outs = frames
    out = getattr(jl, name)(jparams, *(jnp.asarray(a) for a in inputs),
                            EL, 2.0, (0, 0, 0, 0))
    port = outs[name]
    assert set(out) == OUT_KEYS
    for k in ("bit_bl", "bit_el"):
        t, j = float(port[k]), float(out[k])
        assert abs(t - j) <= 3e-3 * max(abs(j), 1.0), (k, t, j)
    for k in DPB_KEYS:
        assert_rel_rms(port["dpb"][k].numpy(), np.asarray(out["dpb"][k]))


def test_staged_int8_serves_the_fused_sites(pair):
    """int8 at packed width 2 with the port's own calibration: each
    staged frame serves the fused frame's sites as many times, and keeps
    its DPB bit for bit."""
    table = calibrate_video(pair[1], size=EL[0], frames=1, device="cpu",
                            od_offset_cap=OD_OFFSET_CAP_SERVING)
    inputs = _inputs(4)
    runs = {}
    for name in ("forward_one_frame",) + STAGED:
        model = _model(pair[1], precision="int8", packed_width=2,
                       int8_table=table)
        out = _port(model, name, inputs)
        runs[name] = (out, set(model.mode.int8.served),
                      model.mode.int8.calls)
    fused, served, calls = runs["forward_one_frame"]
    assert served and calls > len(served)
    for name in STAGED:
        out, s, c = runs[name]
        assert (s, c) == (served, calls), name
        for k in DPB_KEYS:
            assert torch.equal(out["dpb"][k], fused["dpb"][k]), (name, k)
