"""Real bitstreams of the two-layer P-frame (LSSVCExtend: the BL's DMC
stream, then the EL's, four checkerboard passes), the port against the
JAX package, EL 128x128 / BL 64x64, full widths, fp32, the OffsetDiversity
cap at the serving 10 px on both sides, on the CPU.

As tests/test_torch_stream.py: the closed loop bit for bit (the EL
encoder's DPB equals its decoder's), bits equal to 8 x the files' sizes,
the decoded DPB within 5% relative RMS of the JAX package's, bits within
1%, and the share of scale indexes (mv_y and the four y passes of both
layers) that differ from the JAX package's printed and held to 1%, and
the CDF rows that differ, to 10%.
Weights are the JAX package's `init_lssvc(0)` bridged by `params_from_jax`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_rel_rms
from torch_stream_utils import (as_np, assert_bits_close,
                                index_mismatch_share, record_indexes,
                                table_rows_differ)
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.models.lssvc import LSSVCExtend as JLSSVC
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.utils.stream import filesize

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)
DPB = ("ref_frame_bl", "ref_feature_bl", "ref_frame_el", "ref_feature_el")


@pytest.fixture(scope="module")
def pair():
    jparams = j_init_lssvc(0)
    tm = LSSVCExtend(params_from_jax({k: np.asarray(v)
                                      for k, v in jparams.items()}, "lssvc"),
                     device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING)
    jm = JLSSVC(jparams)
    for m in (tm, jm):
        m.set_scale_information(2.0, EL, (0, 0, 0, 0))
        m.update(force=True)
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)  # read when JAX traces
    jax.clear_caches()
    yield jm, tm
    set_od_offset_cap(None)
    jax.clear_caches()


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    return a(*BL, 3), a(*EL, 3), {
        "ref_frame_bl": a(*BL, 3), "ref_feature_bl": a(*BL, 64),
        "ref_frame_el": a(*EL, 3), "ref_feature_el": a(*EL, 48)}


def test_lssvc_stream_matches_jax(pair, tmp_path):
    jm, tm = pair
    x_bl, x_el, dpb_np = _inputs(5)
    dpb = {k: torch.from_numpy(v) for k, v in dpb_np.items()}
    xb, xe = torch.from_numpy(x_bl), torch.from_numpy(x_el)

    # the EL's closed loop, on the BL's decoded DPB
    bl = tm.base_layer_model.compress(xb, dpb)["dpb"]
    dpb_el = dict(dpb, texture=bl["ref_feature_bl"], y_hat_bl=bl["y_hat_bl"],
                  mv_hat_bl=bl["mv_hat_bl"])
    enc = tm.compress(xe, dpb_el)
    dec = tm.decompress(enc["string"], *EL, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        assert torch.equal(enc["dpb"][k], dec["dpb"][k]), k

    coders = (tm.base_layer_model._coder, tm._coder)
    port_idx = [record_indexes(c, "encode_gaussian", 1) for c in coders]
    paths = [tmp_path / f"{n}.bin" for n in ("bl", "el", "jbl", "jel")]
    out = tm.encode_decode(xb, xe, dpb, paths[0], paths[1], EL[1], EL[0],
                           BL[1], BL[0])
    for c in coders:
        del c.encode_gaussian
    assert out["bit_bl"] == 8 * filesize(paths[0])
    assert out["bit_el"] == 8 * filesize(paths[1])
    for k in ("ref_frame_el", "ref_feature_el"):
        assert torch.equal(out["dpb"][k], dec["dpb"][k]), k
    assert len(port_idx[1]) == 5  # mv_y, then the four passes of y
    assert all(out[k] > 0 for k in ("encoding_time_BL", "decoding_time_BL",
                                    "encoding_time_EL", "decoding_time_EL"))

    coders = (jm.base_layer_model._coder, jm._coder)
    jax_idx = [record_indexes(c, "encode_gaussian", 1) for c in coders]
    ref = jm.encode_decode_extend(
        jnp.asarray(x_bl), jnp.asarray(x_el),
        {k: jnp.asarray(v) for k, v in dpb_np.items()}, str(paths[2]),
        str(paths[3]), EL[1], EL[0], BL[1], BL[0])
    for c in coders:
        del c.encode_gaussian
    for k in ("bit_bl", "bit_el"):
        assert_bits_close(out[k], ref[k], f"LSSVC {k}")
    for k in DPB:
        assert_rel_rms(out["dpb"][k].numpy(), as_np(ref["dpb"][k]))
    index_mismatch_share(port_idx[0] + port_idx[1], jax_idx[0] + jax_idx[1],
                         "LSSVC BL mv_y, y; EL mv_y, 4 passes of y")


def test_tables_against_jax(pair):
    """Both layers' CDF tables; the rows that differ from the JAX
    package's (a float32 ulp of the probe network) are held to 10%."""
    jm, tm = pair
    for name, t, j in (("EL", tm, jm),
                       ("BL", tm.base_layer_model, jm.base_layer_model)):
        for k in ("z_table", "z_mv_table", "gaussian_table"):
            table_rows_differ(getattr(t._coder, k), getattr(j._coder, k),
                              f"LSSVC {name} {k}")


@pytest.mark.parametrize("recorder", ["off", "on"])
def test_decode_profiling_keys_are_the_jax_stage_names(pair, tmp_path,
                                                       recorder):
    """Both layers' profiling dicts carry the JAX package's stage names,
    each filled by one decode, folded from the decoder's spans whether the
    span recorder (`utils/spans.py`) is off or on; on, its ring also holds
    the frame's spans."""
    from lssvc_tpu_torch.utils import spans

    jm, tm = pair
    x_bl, x_el, dpb_np = _inputs(6)
    dpb = {k: torch.from_numpy(v) for k, v in dpb_np.items()}
    layers = (tm.base_layer_model, tm)
    for m in layers:
        m.profile_decoding = True
        m.reset_decoding_profiling()
    spans.clear()
    spans.enable(recorder == "on")
    try:
        tm.encode_decode(torch.from_numpy(x_bl), torch.from_numpy(x_el), dpb,
                         tmp_path / "bl.bin", tmp_path / "el.bin", EL[1],
                         EL[0], BL[1], BL[0])
    finally:
        spans.enable(False)
        for m in layers:
            m.profile_decoding = False
    names = [r["name"] for r in spans.snapshot()["spans"]]
    spans.clear()
    if recorder == "off":
        assert names == []
    else:
        assert names.count("lssvc.p.decode") == 1
        assert {m.stage_spans[k] for m in layers
                for k in m.DECODING_STAGES} <= set(names)
    for m, jlayer in zip(layers, (jm.base_layer_model, jm)):
        prof = m.get_average_decoding_profiling()
        assert list(prof) == list(jlayer.decoding_profiling)
        assert prof["frames"] == 1
        assert all(v > 0 for v in prof.values())
    # both layers' stages follow one another on one timeline and sum to
    # "overall", less the Python between two spans
    profs = [m.get_average_decoding_profiling() for m in layers]
    stages = sum(v for prof in profs for k, v in prof.items()
                 if k not in ("frames", "overall"))
    assert profs[0]["overall"] == profs[1]["overall"]
    assert 0.9 * profs[0]["overall"] <= stages <= profs[0]["overall"]
