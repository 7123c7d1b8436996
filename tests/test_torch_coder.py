"""The port's stream-path building blocks against the JAX package's: the
CDF tables, the scale -> table-row maps, the symbol order, the bin file
format, the finiteness guards and the DPB clamp.

The Laplace and Gaussian tables are numpy on both sides and equal.  The
factorized tables (BitEstimator, EntropyBottleneck) probe each side's own
network in float32; with the JAX package's network substituted for the
port's, the port's builders give the JAX package's tables row for row, so
any other difference is a float32 ulp of the probe (the models' tables
are held in tests/test_torch_stream*.py).  The index maps are equal
between the scale tables' bucket edges; on an edge, where the index is an
integer give or take an ulp of `log`, they may differ by one bucket.
"""

import math
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_stream_utils import table_rows_differ
from lssvc_tpu.convert import P as JP
from lssvc_tpu.entropy import coder as jcoder
from lssvc_tpu.entropy import models as jent
from lssvc_tpu.models.init import Builder, Rng
from lssvc_tpu.utils import checks as jchecks
from lssvc_tpu.utils import stream as jstream
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.entropy import coder as tcoder
from lssvc_tpu_torch.entropy import models as tent
from lssvc_tpu_torch.utils import checks as tchecks
from lssvc_tpu_torch.utils import stream as tstream


def _equal_tables(port, ref):
    for a in ("cdfs", "sizes", "offsets"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a))


def test_laplace_and_gaussian_tables_equal_jax():
    _equal_tables(tcoder.build_laplace_table(), jcoder.build_laplace_table())
    _equal_tables(tcoder.build_gaussian_conditional_table(),
                  jcoder.build_gaussian_conditional_table())
    np.testing.assert_array_equal(tent.GAUSSIAN_SCALE_TABLE_VIDEO,
                                  jent.GAUSSIAN_SCALE_TABLE_VIDEO)
    np.testing.assert_array_equal(tent.GAUSSIAN_SCALE_TABLE_IMG,
                                  jent.GAUSSIAN_SCALE_TABLE_IMG)


def _probe_params(seed):
    """Bit estimators (128 and 64 channels) and a 64-channel bottleneck,
    perturbed so that every term and the medians count."""
    rng = np.random.default_rng(seed)
    b = Builder(Rng(seed))
    b.bit_estimator("bit_estimator_z", 128)
    b.bit_estimator("bit_estimator_z_mv", 64)
    b.entropy_bottleneck("entropy_bottleneck", 64)
    jp = {k: np.asarray(v) for k, v in b.d.items()}
    for k in jp:
        if k.startswith("bit_estimator"):
            jp[k] = jp[k] + 0.5 * rng.normal(size=jp[k].shape)
        elif "_factors" in k or "quantiles" in k:
            jp[k] = jp[k] + 3 * rng.normal(size=jp[k].shape)
        jp[k] = jp[k].astype(np.float32)
    return jp, params_from_jax(jp, "dmc")


@pytest.mark.parametrize("seed", range(2))
def test_factorized_tables_equal_jax_with_its_probe(seed, monkeypatch):
    """With the JAX package's probe network in place of the port's, the
    port's builders give the JAX package's tables row for row; with its
    own, the rows that differ are counted (a float32 ulp of the probe)."""
    jp, tp = _probe_params(seed)
    jjp = {k: jnp.asarray(v) for k, v in jp.items()}
    refs = {"bit_estimator_z.": jcoder.build_bit_estimator_table(
                jjp, "bit_estimator_z."),
            "bit_estimator_z_mv.": jcoder.build_bit_estimator_table(
                jjp, "bit_estimator_z_mv."),
            "entropy_bottleneck.": jcoder.build_entropy_bottleneck_table(
                jjp, "entropy_bottleneck.")}

    def own():
        return {k: (tcoder.build_entropy_bottleneck_table(tp, k)
                    if k.startswith("entropy") else
                    tcoder.build_bit_estimator_table(tp, k)) for k in refs}

    for k, table in own().items():
        table_rows_differ(table, refs[k], f"seed {seed} {k}")

    def jax_bit_estimator(p, x):
        out = jent.bit_estimator_forward(
            JP(jjp, p.prefix), jnp.asarray(x.numpy()))
        return torch.from_numpy(np.array(out))

    def jax_logits(p, x, filters):
        out = jent.entropy_bottleneck_logits(
            JP(jjp, p.prefix), jnp.asarray(x.numpy()), filters)
        return torch.from_numpy(np.array(out))

    monkeypatch.setattr(tcoder, "bit_estimator_forward", jax_bit_estimator)
    monkeypatch.setattr(tcoder, "entropy_bottleneck_logits", jax_logits)
    for k, table in own().items():
        _equal_tables(table, refs[k])


@pytest.mark.parametrize("name", ["video", "img"])
def test_index_maps_equal_jax(name):
    """Equal between the bucket edges and at the clamps.  On an edge the
    index is an integer give or take an ulp of each framework's float32
    `log`, so there the two may differ by one bucket (JAX's own map is not
    monotone across the table's entries there); such differences are
    counted, and held to one bucket within 1e-4 of an edge."""
    table = getattr(tent, f"GAUSSIAN_SCALE_TABLE_{name.upper()}")
    port = getattr(tent, f"build_indexes_{name}")
    ref = getattr(jent, f"build_indexes_{name}")
    lo, hi, n = (0.01, 64.0, 256) if name == "video" else (0.11, 256.0, 64)

    def both(s):
        s = np.asarray(s, np.float32)
        out = port(torch.from_numpy(s)).numpy()
        assert out.dtype == np.int32
        return out, np.asarray(ref(jnp.asarray(s)))

    def edge_flips(s, what):
        out, want = both(s)
        bad = np.nonzero(out != want)[0]
        print(f"build_indexes_{name} {what}: {bad.size} of {s.size} differ")
        assert np.all(np.abs(out[bad] - want[bad]) == 1)
        exact = ((np.log(np.asarray(s, np.float64)[bad]) - math.log(lo))
                 / ((math.log(hi) - math.log(lo)) / (n - 1)))
        assert np.all(np.abs(exact - np.rint(exact)) < 1e-4)
        return bad.size

    # between the edges (geometric midpoints) and the clamps: equal
    mids = np.sqrt(table[:-1].astype(np.float64) * table[1:])
    out, want = both(np.concatenate([mids, [0.0, -1.0, 1e-6, 1e-5, 1e4,
                                            np.inf]]))
    np.testing.assert_array_equal(out, want)
    # on the edges and their float neighbours
    edge_flips(np.concatenate([table, np.nextafter(table, 0),
                               np.nextafter(table, np.inf)]), "on the edges")
    rng = np.random.default_rng(11)
    s = np.exp(rng.uniform(-7, 7, 200_000))
    assert edge_flips(s, "on log-uniform scales") <= 1e-4 * s.size


def test_symbol_order_is_nchw_flat():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    flat = tcoder.to_symbol_order(x)
    np.testing.assert_array_equal(
        flat, jcoder.nhwc_to_symbol_order(np.asarray(x.numpy())))
    assert flat.dtype == np.int32
    back = tcoder.from_symbol_order(flat, x.shape, "cpu")
    assert back.is_contiguous() and torch.equal(back, x)
    np.testing.assert_array_equal(tcoder.channel_indexes((2, 3, 4, 5)),
                                  jcoder.channel_indexes((2, 3, 4, 5)))


def test_stream_files_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    y, z, s = (bytes(rng.integers(0, 256, n, dtype=np.uint8))
               for n in (1000, 37, 513))
    ti, ji, tp, jp = (tmp_path / n for n in ("t.i", "j.i", "t.p", "j.p"))
    tstream.encode_i(1088, 1920, y, z, ti)
    jstream.encode_i(1088, 1920, y, z, str(ji))
    tstream.encode_p(s, tp)
    jstream.encode_p(s, str(jp))
    assert ti.read_bytes() == ji.read_bytes()
    assert tp.read_bytes() == jp.read_bytes()
    assert tstream.decode_i(ji) == (1088, 1920, y, z)
    assert tstream.decode_p(jp) == s
    assert tstream.filesize(ti) == 16 + len(y) + len(z)
    for h, w in ((1080, 1920), (540, 960), (104, 120), (64, 64)):
        assert tstream.get_downsampled_shape(h, w, 64) == \
            jstream.get_downsampled_shape(h, w, 64)
    # a truncated file is an error, not a short stream
    ti.write_bytes(ti.read_bytes()[:-1])
    with pytest.raises(ValueError, match="truncated"):
        tstream.decode_i(ti)
    tp.write_bytes(struct.pack(">I", 10) + b"abc")
    with pytest.raises(ValueError, match="truncated"):
        tstream.decode_p(tp)


def test_sanitize_dpb_matches_jax():
    rng = np.random.default_rng(4)
    frame = (rng.normal(size=(1, 8, 8, 3)) * 6).astype(np.float32)
    feature = (rng.normal(size=(1, 8, 8, 4)) * 1e5).astype(np.float32)
    frame[0, 0, 0] = [np.nan, np.inf, -np.inf]
    feature[0, 1, 1] = [np.nan, np.inf, -np.inf, 7.0]
    dpb = {"ref_frame_bl": frame, "ref_feature_el": feature,
           "ref_feature_bl": None}
    out = tchecks.sanitize_dpb({k: None if v is None else torch.from_numpy(v)
                                for k, v in dpb.items()})
    ref = jchecks.sanitize_dpb({k: None if v is None else jnp.asarray(v)
                                for k, v in dpb.items()})
    assert out["ref_feature_bl"] is None
    for k in ("ref_frame_bl", "ref_feature_el"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    healthy = torch.from_numpy(rng.random((1, 8, 8, 3), np.float32))
    assert torch.equal(tchecks.sanitize_dpb({"ref_frame_el": healthy})
                       ["ref_frame_el"], healthy)


def test_finiteness_guards():
    good, bad = torch.ones(3), torch.tensor([1.0, float("nan")])
    tchecks.assert_finite("x", a=good)
    with pytest.raises(FloatingPointError, match=r"\['b'\]"):
        tchecks.raise_if_nonfinite("x", tchecks.finite_flags(a=good, b=bad))
    with pytest.raises(FloatingPointError, match="refusing"):
        tchecks.assert_finite_np("x", a=np.array([np.inf]))
    coder = tcoder.IntraCoder.__new__(tcoder.IntraCoder)
    coder.medians = np.zeros(2, np.float32)
    with pytest.raises(FloatingPointError, match="EntropyBottleneck"):
        coder.eb_compress(torch.full((1, 2, 2, 2), float("nan")))


def test_video_coder_round_trip_through_either_decoder():
    """One buffered stream (a factorized plane, then a Gaussian plane with
    its index plane) decodes through the coder's own decoder and through
    an independent `open_stream` handle to the coded symbols, NHWC."""
    _, tp = _probe_params(2)
    coder = tcoder.VideoCoder(tp)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.integers(-4, 5, (1, 3, 5, 64)).astype(np.float32))
    y = torch.from_numpy(rng.integers(-90, 90, (1, 6, 10, 32))
                         .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 256, (1, 6, 10, 32))
                           .astype(np.int32))
    coder.reset_encoder()
    coder.encode_factorized(z, coder.z_mv_table)
    coder.encode_gaussian(y, idx)
    string = coder.flush()
    coder.set_stream(string)
    for dec in (coder, coder.open_stream(string)):
        z_dec = dec.decode_factorized(z.shape, coder.z_mv_table, "cpu")
        y_dec = dec.decode_gaussian(idx)
        assert z_dec.is_contiguous() and torch.equal(z_dec, z)
        assert y_dec.is_contiguous() and torch.equal(y_dec, y)
