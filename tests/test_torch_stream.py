"""Real bitstreams of the base-layer P-frame (DMCExtend at 64x64) and of
the I-frame pair (IntraNoAR at 64x64; IntraSS at EL 128x128 / BL 64x64,
full widths), the port against the JAX package, fp32, on the CPU.

For each model: the port's encoder's closed-loop output equals its
decoder's bit for bit; its bits are 8 x its files' sizes; its decoded
reconstruction is within the 5% relative RMS of tests/parity_utils.py of
the JAX package's stream reconstruction, and its bits within 1% of the
JAX package's; the share of its scale indexes that differ from the JAX
package's (last-bit differences of two frameworks, at bucket edges) is
printed and held to 1%; so are the CDF rows that differ from the JAX
package's, to 10%.  Weights are the JAX package's inits
(`init_dmc(0)`, `init_intra_ss(192)`) bridged by `params_from_jax`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parity_utils import assert_rel_rms
from torch_stream_utils import (as_np, assert_bits_close,
                                index_mismatch_share, record_indexes,
                                table_rows_differ)
from lssvc_tpu.models.dmc import DMCExtend as JDMC
from lssvc_tpu.models.init import init_dmc as j_init_dmc
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.intra_noar import IntraNoAR as JIntraNoAR
from lssvc_tpu.models.intra_ss import IntraSS as JIntraSS
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models import IntraSS
from lssvc_tpu_torch.models.dmc_stream import DMCExtend
from lssvc_tpu_torch.models.intra_ss_stream import compress_stream
from lssvc_tpu_torch.utils.stream import filesize

from torch_threads import share_cores

share_cores()

BL_PREFIX = "base_layer_model."
DPB_BL = ("ref_frame_bl", "ref_feature_bl", "y_hat_bl", "mv_hat_bl")


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.random((1, *s), np.float32) for s in shapes]


def _equal(a, b, what):
    assert a.shape == b.shape and torch.equal(a, b), what


@pytest.fixture(scope="module")
def dmc_pair():
    jparams = j_init_dmc(0)
    jm = JDMC(jparams)
    jm.update(force=True)
    tm = DMCExtend(params_from_jax(_np(jparams), "dmc"), device="cpu")
    tm.update(force=True)
    return jm, tm


@pytest.mark.parametrize("with_feature", [True, False])
def test_dmc_stream_matches_jax(dmc_pair, tmp_path, with_feature):
    """A P-frame after a P-frame (a DPB feature) and after an I-frame."""
    jm, tm = dmc_pair
    x, ref, feat = _inputs(1 + with_feature,
                           [(64, 64, 3), (64, 64, 3), (64, 64, 64)])
    dpb = {"ref_frame_bl": torch.from_numpy(ref),
           "ref_feature_bl": torch.from_numpy(feat) if with_feature
           else None}

    enc = tm.compress(torch.from_numpy(x), dpb)
    dec = tm.decompress(enc["string"], 64, 64, dpb)
    for k in DPB_BL:
        _equal(enc["dpb"][k], dec["dpb"][k], k)

    port_idx = record_indexes(tm._coder, "encode_gaussian", 1)
    out = tm.encode_decode(torch.from_numpy(x), dpb, tmp_path / "p.bin",
                           64, 64)
    assert out["bit"] == 8 * filesize(tmp_path / "p.bin")
    for k in DPB_BL:
        _equal(out["dpb"][k], dec["dpb"][k], k)
    del tm._coder.encode_gaussian

    jax_idx = record_indexes(jm._coder, "encode_gaussian", 1)
    jdpb = {"ref_frame_bl": jnp.asarray(ref),
            "ref_feature_bl": jnp.asarray(feat) if with_feature else None}
    ref_out = jm.encode_decode_extend(jnp.asarray(x), jdpb,
                                      str(tmp_path / "j.bin"), 64, 64)
    del jm._coder.encode_gaussian
    assert_bits_close(out["bit"], ref_out["bit"], "DMC")
    for k in DPB_BL:
        assert_rel_rms(out["dpb"][k].numpy(), as_np(ref_out["dpb"][k]))
    index_mismatch_share(port_idx, jax_idx, "DMC mv_y, y")


def test_tables_against_jax(dmc_pair, intra_pair):
    """The models' CDF tables: the rows that differ from the JAX package's
    (a float32 ulp of the probe network) are counted and held to 10%."""
    jm, tm = dmc_pair
    for k in ("z_table", "z_mv_table", "gaussian_table"):
        table_rows_differ(getattr(tm._coder, k), getattr(jm._coder, k),
                          f"DMC {k}")
    jss, tss, _ = intra_pair
    for name, t, j in (("IntraSS EL", tss, jss),
                       ("IntraNoAR", tss.base_layer_model,
                        jss.base_layer_model)):
        for k in ("eb_table", "gc_table"):
            table_rows_differ(getattr(t._coder, k), getattr(j._coder, k),
                              f"{name} {k}")
        np.testing.assert_array_equal(t._coder.medians, j._coder.medians)


@pytest.fixture(scope="module")
def intra_pair():
    """The JAX package's IntraSS init (BL 192), its IntraNoAR part, and
    both bridged; tables built on both sides."""
    jparams = j_init_intra_ss(192)
    tparams = params_from_jax(_np(jparams), "intra_ss")
    jss = JIntraSS(jparams, channel_BL=192)
    tss = IntraSS(tparams, device="cpu")
    jbl = JIntraNoAR({k[len(BL_PREFIX):]: v for k, v in jparams.items()
                      if k.startswith(BL_PREFIX)})
    for m in (jss, tss, jbl):
        m.update(force=True)
    return jss, tss, jbl


def test_intra_noar_stream_matches_jax(intra_pair, tmp_path):
    _, tss, jbl = intra_pair
    tbl = tss.base_layer_model
    (x,) = _inputs(3, [(64, 64, 3)])
    xt = torch.from_numpy(x)

    enc = tbl.compress(xt, with_recon=True)
    dec = tbl.decompress(enc["strings"], enc["shape"])
    for k in ("x_hat", "y_hat"):
        _equal(enc[k], dec[k], k)

    port_idx = record_indexes(tbl._coder, "gc_compress", 1)
    out = tbl.encode_decode(xt, tmp_path / "i.bin", 64, 64)
    del tbl._coder.gc_compress
    assert out["bit"] == 8 * filesize(tmp_path / "i.bin")
    _equal(out["x_hat"], dec["x_hat"], "x_hat")

    jax_idx = record_indexes(jbl._coder, "gc_compress", 1)
    ref = jbl.encode_decode(jnp.asarray(x), str(tmp_path / "j.bin"), 64, 64)
    del jbl._coder.gc_compress
    assert_bits_close(out["bit"], ref["bit"], "IntraNoAR")
    for k in ("x_hat", "y_hat"):
        assert_rel_rms(out[k].numpy(), as_np(ref[k]))
    index_mismatch_share(port_idx, jax_idx, "IntraNoAR y")


def test_intra_ss_stream_matches_jax(intra_pair, tmp_path):
    jss, tss, _ = intra_pair
    x_bl, x_el = _inputs(4, [(64, 64, 3), (128, 128, 3)])
    for m in (jss, tss):
        m.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    paths = [tmp_path / f"{n}.bin" for n in ("bl", "el", "jbl", "jel")]

    enc = compress_stream(tss, torch.from_numpy(x_bl), torch.from_numpy(x_el),
                          paths[0], paths[1], 64, 64, 128, 128)
    port_idx = [record_indexes(c, "gc_compress", 1)
                for c in (tss.base_layer_model._coder, tss._coder)]
    out = tss.encode_decode(torch.from_numpy(x_bl), torch.from_numpy(x_el),
                            paths[0], paths[1], 64, 64, 128, 128)
    for c in (tss.base_layer_model._coder, tss._coder):
        del c.gc_compress
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        _equal(enc[k], out[k], k)
    assert out["bit_bl"] == 8 * filesize(paths[0])
    assert out["bit_el"] == 8 * filesize(paths[1])

    jax_idx = [record_indexes(c, "gc_compress", 1)
               for c in (jss.base_layer_model._coder, jss._coder)]
    ref = jss.encode_decode(jnp.asarray(x_bl), jnp.asarray(x_el),
                            str(paths[2]), str(paths[3]), pic_height_bl=64,
                            pic_width_bl=64, pic_height_el=128,
                            pic_width_el=128)
    for c in (jss.base_layer_model._coder, jss._coder):
        del c.gc_compress
    for k in ("bit_bl", "bit_el"):
        assert_bits_close(out[k], ref[k], f"IntraSS {k}")
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        assert_rel_rms(out[k].numpy(), as_np(ref[k]))
    index_mismatch_share(port_idx[0] + port_idx[1], jax_idx[0] + jax_idx[1],
                         "IntraSS BL y, EL y")
