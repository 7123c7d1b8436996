"""The int8 serving precision of the port against the JAX package's, on the
CPU.

The port runs its plain int8 convolution (`int8_conv2d_plain`, an exact
integer conv); the JAX package runs `lax.conv_general_dilated` with s32
accumulation on JAX-CPU, in the same process.  Its int8 state is global:
every test that sets it restores fp32, packed width 1, no cap and an empty
table in a `finally`, and clears JAX's caches between tables.  Inputs come
from numpy seeds; the model tests run the full-width LSSVC at EL 128x128 /
BL 64x64 with the serving 10 px OffsetDiversity cap, weights from the
port's init through the JAX package's converter and back.

Tolerances:
  * the s32 accumulator: equal to the JAX package's, exactly;
  * `quant_weight`, `requant`, `fixed_point_multiplier`, `requant_fixed`:
    equal; `quant_act` equal but for ties the JAX package may round the
    other way (at most 1e-4 of the elements, by 1; 0 measured); `dequant`
    within 1 f32 ulp (equal measured);
  * a site (`pconv`, `pconv_dw`, `p_res_block`) in int8 on the same bf16
    input and table: equal to the JAX package run op by op; under jax.jit,
    whose epilogue is an FMA, at most 1e-4 of the elements one bf16 ulp
    off (2.7e-5 measured);
  * the recorder: the JAX package's key set, each absmax within 3%
    relative (both sides run bf16, which rounds in other places; 2.0%
    measured).  The JAX package's model forwards here warp with f32 flows,
    as its TPU kernels do (`_tpu_flow_warp`): its CPU warp computes bf16
    flows' sample positions in bf16, which put one site 6.4% off;
  * the int8 P-frame: bits within 2%; the EL reconstruction within 1.5x
    the distance between the JAX package's own int8 and bf16-packed
    frames (random-init per-tensor PTQ is chaotic: the JAX package's own
    test measures 0.25 relative against float, `tests/test_int8.py`).
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lssvc_tpu.convert import P as JP
from lssvc_tpu.convert import convert_state_dict
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.models import packed_blocks as jpb
from lssvc_tpu.ops import int8 as jq8
from lssvc_tpu.ops import warp_pallas as jwp
from lssvc_tpu.ops.nn import (
    set_od_offset_cap,
    set_packed_width,
    set_precision_mode,
)
from lssvc_tpu_torch.convert import P, params_from_jax
from lssvc_tpu_torch.harness import calibrate
from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models import packed_blocks as tpb
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops import int8 as q8
from lssvc_tpu_torch.ops.nn import Mode, precision_from_cli, precision_scope
from lssvc_tpu_torch.parallel import scheduler

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)


def _tpu_flow_warp(x, flow):
    """The JAX package's CPU flow warp as its TPU path runs it: the flow
    in f32 (`warp_pallas.py:1271`), the result in x's dtype.  Its CPU path
    (`warp_pallas.py:1262-1264`) computes the sample positions in the
    flow's own dtype (`ops/warp.py:59-61`), so a bf16 flow rounds a 0.08 px
    offset away at row 74 (bf16's spacing is 0.5 there); the port's warps,
    like the TPU kernels they stand for, take the flow in f32."""
    return _XLA_FLOW_WARP(x, flow.astype(jnp.float32)).astype(x.dtype)


_XLA_FLOW_WARP = jwp._flow_warp_xla


@contextlib.contextmanager
def jax_int8(mode, table=None, packed_width=2):
    """The JAX package in `mode` at `packed_width` with the serving cap,
    `table` and its warps taking f32 flows (`_tpu_flow_warp`), then back
    to fp32, packed width 1, no cap, no table and its own warp."""
    set_precision_mode(mode)
    set_packed_width(packed_width)
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)
    jq8.set_calibration(table or {})
    jq8._SERVED.clear()  # the JAX package's served set outlives its tables
    jwp._flow_warp_xla = _tpu_flow_warp
    jax.clear_caches()
    try:
        yield
    finally:
        jwp._flow_warp_xla = _XLA_FLOW_WARP
        set_precision_mode("fp32")
        set_packed_width(1)
        set_od_offset_cap(None)
        jq8.set_calibration({})
        jax.clear_caches()


def port_mode(precision, table=None):
    """A model-free mode for a site: packed width 2, `table` served."""
    return precision_scope(Mode(precision, 2, cache={},
                                int8=q8.Int8Sites(dict(table or {}))))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


# --- the integer convolution and the helpers --------------------------------

# (x shape, (cout, kh, kw), stride, padding)
CONV_CASES = [
    ((1, 9, 14, 96), (96, 3, 3), 1, ((1, 1), (1, 1))),
    ((1, 9, 14, 96), (64, 1, 1), 1, ((0, 0), (0, 0))),
    ((1, 11, 13, 32), (40, 7, 3), 1, ((3, 3), (1, 1))),
    ((1, 11, 13, 32), (40, 7, 3), 1, ((3, 3), (1, 0))),
    ((1, 11, 14, 102), (48, 3, 3), 2, ((1, 1), (1, 0))),
    ((1, 8, 10, 102), (24, 3, 3), 1, ((1, 1), (1, 1))),
    ((2, 7, 9, 64), (16, 3, 3), 1, ((1, 1), (1, 1))),
]


def _s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("xs,ws,stride,pad", CONV_CASES)
def test_plain_int8_conv_equals_jax(xs, ws, stride, pad):
    """The plain s8 conv's s32 accumulator equals the JAX package's
    `int8_conv2d` exactly (the kernel is held to the plain version bit for
    bit on the card, `tests/test_torch_cuda.py`)."""
    rng = np.random.default_rng(sum(xs) + ws[0])
    x, w = _s8(rng, xs), _s8(rng, (ws[1], ws[2], xs[3], ws[0]))  # HWIO
    want = np.asarray(jq8.int8_conv2d(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride, padding=pad))
    got = q8.int8_conv2d(torch.from_numpy(x),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                         stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_int8_conv_in_bands_of_rows(monkeypatch):
    """The plain version computes bands of output rows (to bound its
    im2col on the card); bands of one and of a few rows give the one-band
    result, stride 2 and batch 2 included."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_s8(rng, (2, 23, 17, 24)))
    w = torch.from_numpy(_s8(rng, (8, 24, 7, 3)))
    for stride, pad in ((1, ((3, 3), (1, 1))), (2, ((3, 3), (1, 0)))):
        whole = q8.int8_conv2d_plain(x, w, stride, pad)
        for rows in (1, 3):
            monkeypatch.setattr(q8, "PLAIN_BAND",
                                rows * 2 * whole.shape[2] * 24 * 21)
            assert torch.equal(q8.int8_conv2d_plain(x, w, stride, pad),
                               whole)
        monkeypatch.undo()


def test_plain_int8_conv_full_scale_at_the_largest_k():
    """All +-127 at K = 7*3*256 = 5376, the largest of the path: the
    interior accumulator is +-127^2 * 5376, exact on both sides."""
    x = np.full((1, 9, 5, 256), 127, np.int8)
    w = np.full((7, 3, 256, 8), -127, np.int8)
    w[..., 4:] = 127
    pad = ((3, 3), (1, 1))
    want = np.asarray(jq8.int8_conv2d(jnp.asarray(x), jnp.asarray(w),
                                      padding=pad))
    got = q8.int8_conv2d(torch.from_numpy(x),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), 1,
                         pad).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 4, 2, 0] == -127 * 127 * 5376
    assert got[0, 4, 2, 7] == 127 * 127 * 5376


def test_helpers_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 24)).astype(np.float32)
    # exact .5 ties at the scale, where rounding half to even decides
    x[0, 0, :8, 0] = (np.arange(8) + 0.5) * np.float32(0.0625)
    w = (rng.standard_normal((3, 3, 24, 16)) * 0.2).astype(np.float32)
    w[..., 3] = 0.0  # a dead channel: scale 1e-8 / 127
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())

    for s in (0.0625, 0.0173):
        got = q8.quant_act(torch.from_numpy(x), s).numpy().astype(np.int32)
        want = np.asarray(jq8.quant_act(jnp.asarray(x), s), np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_array_equal(
        q8.quant_act(torch.from_numpy(x[0, 0, :8, :1]), 0.0625).numpy()
        .ravel(), np.asarray([0, 2, 2, 4, 4, 6, 6, 8], np.int8))

    wq, ws = q8.quant_weight(w_oihw)
    jwq, jws = jq8.quant_weight(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))

    acc = q8.int8_conv2d(q8.quant_act(torch.from_numpy(x), 0.02), wq)
    jacc = jnp.asarray(acc.numpy())
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    got = q8.dequant(acc, 0.02, ws, torch.from_numpy(b)).numpy()
    want = np.asarray(jq8.dequant(jacc, 0.02, jws, jnp.asarray(b)))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    for relu in (False, True):
        np.testing.assert_array_equal(
            q8.requant(acc, 0.02, ws, 0.05, torch.from_numpy(b), relu)
            .numpy(),
            np.asarray(jq8.requant(jacc, 0.02, jws, 0.05, jnp.asarray(b),
                                   relu)))
    triple = q8.fixed_point_multiplier(0.02, ws.numpy(), 0.05, w_q=wq)
    jtriple = jq8.fixed_point_multiplier(0.02, np.asarray(jws), 0.05,
                                         w_q=np.asarray(jwq))
    for a, b_ in zip(triple, jtriple):
        np.testing.assert_array_equal(a, b_)
    for relu in (False, True):
        np.testing.assert_array_equal(
            q8.requant_fixed(acc, *triple, relu=relu).numpy(),
            np.asarray(jq8.requant_fixed(jacc, *(jnp.asarray(t)
                                                 for t in jtriple),
                                         relu=relu)))
    got = q8.int8_conv_ref(torch.from_numpy(x), w_oihw, 0.02,
                           torch.from_numpy(b)).numpy()
    want = np.asarray(jq8.int8_conv_ref(jnp.asarray(x), jnp.asarray(w), 0.02,
                                        jnp.asarray(b)))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert q8.calib_act_scale(x, 99.0) == jq8.calib_act_scale(x, 99.0)
    stats = {"a.": np.float32(3.5), "b.": 0.0}
    assert q8.table_from_stats(stats, 1.1) == jq8.table_from_stats(stats, 1.1)


# --- one site --------------------------------------------------------------

def _site_params(rng, c, k=3, p_dw=False):
    """JAX (HWIO) and port (OIHW) weights of scope "s.": conv1/conv2 of a
    residual block, a plain conv, and a depthwise conv."""
    def w(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    jp = {"s.weight": w(k, k, c, c), "s.bias": w(c, scale=0.05),
          "s.depth_conv.weight": w(3, 3, 1, c),
          "s.depth_conv.bias": w(c, scale=0.05)}
    for name in ("conv1", "conv2"):
        jp[f"s.{name}.weight"] = w(3, 3, c, c)
        jp[f"s.{name}.bias"] = w(c, scale=0.05)
    return jp, params_from_jax(jp, "lssvc")


# name -> (JAX call, port call, channels, kernel width, input width)
SITES = {
    "pconv": (lambda s, x: jpb.pconv(s, x), lambda s, x: tpb.pconv(s, x),
              48, 3, 32),
    "pconv_stride2": (lambda s, x: jpb.pconv(s, x, stride=2),
                      lambda s, x: tpb.pconv(s, x, stride=2), 51, 3, 32),
    "pconv_7x7_p4": (lambda s, x: jpb.pconv(s, x, p=4),
                     lambda s, x: tpb.pconv(s, x, p=4), 8, 7, 16),
    "pconv_dw": (jpb.pconv_dw, tpb.pconv_dw, 48, 3, 32),
    "p_res_block": (jpb.p_res_block, tpb.p_res_block, 48, 3, 32),
}


@contextlib.contextmanager
def port_leaky_relu():
    """The JAX package's packed blocks with the port's leaky ReLU, which
    computes a bf16 x * slope in f32 and rounds once (the port's bf16 mode,
    which matches the JAX package's jitted I-frame EL bit for bit), where
    jnp's op alone rounds the slope to bf16 first: p_res_block's ReLUs
    then agree, and the test holds its int8 sites."""
    real = jpb.leaky_relu

    def leaky(x, slope=0.01):
        if x.dtype == jnp.float32:
            return real(x, slope)
        return real(x.astype(jnp.float32), slope).astype(x.dtype)

    jpb.leaky_relu = leaky
    try:
        yield
    finally:
        jpb.leaky_relu = real


@pytest.mark.parametrize("site", sorted(SITES))
def test_int8_site_matches_jax(site):
    """The same bf16 packed input and table through the JAX package's
    int8 site and the port's, every site of the call served on both
    sides.  Against the JAX package run op by op the bf16 output is equal.
    Under jax.jit XLA contracts the epilogue's multiply and add into an
    FMA, which rounds once where the port (and the kernel) round the
    product and then the sum: at most 1e-4 of the elements land on the
    other side of a bf16 rounding boundary (2.7e-5 measured, 1 of 36,864),
    one ulp of the conv's output away (p_res_block adds its input after
    the conv, so its bound is one ulp of both addends, and the sum's own
    rounding)."""
    jcall, tcall, c, k, wp = SITES[site]
    p = 4 if site.endswith("p4") else 2
    rng = np.random.default_rng(len(site))
    jparams, tparams = _site_params(rng, c, k)
    x = (rng.standard_normal((1, 12, wp, p * c)) * 2).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    keys = {"s.": f"s.{c}x{c}", "s.depth_conv.": f"s.depth_conv.1x{c}",
            "s.conv1.": f"s.conv1.{c}x{c}", "s.conv2.": f"s.conv2.{c}x{c}"}
    table = {key: 0.02 + 0.001 * i for i, key in enumerate(keys.values())}
    with port_mode("int8", table) as mode:
        got = _np(tcall(P(tparams, "s."), xb))
    resid = np.abs(_np(xb)) if site == "p_res_block" else 0.0
    for jit in (False, True):
        def fn(v):
            return jcall(JP(jparams, "s."), v)

        with jax_int8("int8", table), port_leaky_relu():
            want = (jax.jit(fn) if jit else fn)(jnp.asarray(x, jnp.bfloat16))
            assert want.dtype == jnp.bfloat16
            assert jq8.served_sites() == mode.int8.served != set()
        want = _np(want)
        if not jit:
            np.testing.assert_array_equal(got, want)
            continue
        bound = (np.abs(want) + resid) * (2.0 ** -6 if site == "p_res_block"
                                          else 2.0 ** -7)
        assert np.all(np.abs(got - want) <= bound)
        assert np.mean(got != want) <= 1e-4


def test_uncalibrated_int8_is_bf16():
    """An int8 site with no scale runs the bf16 path bit for bit, a site
    and a whole P-frame (`tests/test_int8.py:176`)."""
    rng = np.random.default_rng(5)
    _, tparams = _site_params(rng, 48)
    xb = torch.from_numpy(rng.standard_normal((1, 12, 32, 96))
                          .astype(np.float32)).to(torch.bfloat16)
    outs = []
    for prec in ("bf16", "int8"):
        with port_mode(prec) as mode:
            outs.append([f(P(tparams, "s."), xb) for f in (
                tpb.pconv, tpb.pconv_dw, tpb.p_res_block)])
            assert not mode.int8.served
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    params = init_lssvc(torch.Generator().manual_seed(0))
    inputs = _frame_inputs(7)
    frames = []
    with counting_sites() as calls:
        for mode in (dict(precision="bf16"), dict(precision="int8",
                                                  int8_table={})):
            model = _video(params, packed_width=2, **mode)
            frames.append(model.forward_one_frame(*inputs))
    assert calls[0] == 0
    for k in ("ref_frame_el", "ref_feature_el", "ref_frame_bl"):
        assert torch.equal(frames[0]["dpb"][k], frames[1]["dpb"][k]), k
    assert float(frames[0]["bit_el"]) == float(frames[1]["bit_el"])


# --- the whole P-frame -----------------------------------------------------

def _frame_inputs(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return torch.from_numpy(rng.random((1, *shape), np.float32))

    return [a(*BL, 3), a(*EL, 3), a(*BL, 3), a(*EL, 3), a(*BL, 64),
            a(*EL, 48)]


def _video(tparams, **mode):
    model = LSSVC(tparams, device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING,
                  **mode)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    return model


@pytest.fixture(scope="module")
def video_params():
    jparams = convert_state_dict(init_lssvc(torch.Generator().manual_seed(0)),
                                 jl.LSSVC.TRANSPOSED_CONV_KEYS)
    return jparams, params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "lssvc")


@pytest.fixture(scope="module")
def frame_inputs():
    return _frame_inputs(11)


def _jax_args(inputs):
    return [jnp.asarray(t.numpy()) for t in inputs]


@pytest.fixture(scope="module")
def jax_calibrated(video_params, frame_inputs):
    """The JAX package's bf16 packed P-frame under its recorder, inside
    jax.jit: (its output, its absmax stats as floats)."""
    jparams, _ = video_params

    def stats_fwd(params, *args):
        stats = {}
        with jq8.recording(stats):
            out = jl.forward_one_frame(params, *args, EL, 2.0, (0, 0, 0, 0))
        return out, stats

    with jax_int8("bf16"):
        out, stats = jax.jit(stats_fwd)(jparams, *_jax_args(frame_inputs))
        out = jax.tree_util.tree_map(np.asarray, out)
    return out, {k: float(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def table(jax_calibrated):
    return jq8.table_from_stats(jax_calibrated[1])


@pytest.fixture(scope="module")
def jax_int8_frame(video_params, frame_inputs, table):
    """The JAX package's int8 P-frame with `table`, and its served set."""
    jparams, _ = video_params
    with jax_int8("int8", table):
        out = jl._fwd_jit(jparams, *_jax_args(frame_inputs), EL, 2.0,
                          (0, 0, 0, 0))
        out = jax.tree_util.tree_map(np.asarray, out)
        served = jq8.served_sites()
    return out, served


@contextlib.contextmanager
def counting_sites():
    """Count the packed blocks' int8 convolutions (on the CPU the wrapper
    takes the plain version and counts no launch)."""
    real, calls = tpb.int8_conv2d, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    tpb.int8_conv2d = counted
    try:
        yield calls
    finally:
        tpb.int8_conv2d = real


@pytest.fixture(scope="module")
def port_int8_frame(video_params, frame_inputs, table):
    model = _video(video_params[1], precision="int8", packed_width=2,
                   int8_table=table)
    with counting_sites() as calls:
        out = model.forward_one_frame(*frame_inputs)
    return out, model.mode.int8, calls[0]


def test_recording_matches_jax(video_params, frame_inputs, jax_calibrated):
    """The port's recorder on a bf16 packed P-frame: the JAX package's key
    set, each absmax within 3%; the base layer's sites record into the
    same dict, SpyNet's BL and EL sites under one key."""
    model = _video(video_params[1], precision="bf16", packed_width=2)
    with model.recording() as stats:
        model.forward_one_frame(*frame_inputs)
    want = jax_calibrated[1]
    assert set(stats) == set(want) and len(want) == 102
    for k, v in want.items():
        assert float(stats[k]) == pytest.approx(v, rel=0.03), k
    assert model.base_layer_model.mode.int8 is model.mode.int8
    assert model.mode.int8.stats is None


def test_served_sites_match_jax(table, jax_int8_frame, port_int8_frame,
                                tmp_path):
    """The port serves the JAX package's sites under its table, one int8
    convolution a served site call; the table, written as the JAX tool writes it,
    loads through the port's CLI key for key."""
    _, sites, launches = port_int8_frame
    assert sites.served == jax_int8_frame[1] == set(table)
    assert launches == sites.calls > len(table)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(table, indent=2, sort_keys=True))
    precision, loaded = precision_from_cli("int8", str(path))
    assert precision == "int8" and loaded == table


def test_int8_p_frame_matches_jax(jax_calibrated, jax_int8_frame,
                                  port_int8_frame):
    """Bits within 2%; the EL reconstruction within 1.5x the distance
    between the JAX package's own int8 and bf16-packed frames."""
    jbf16, _ = jax_calibrated
    jint8, _ = jax_int8_frame
    port, _, _ = port_int8_frame
    for k in ("bit_bl", "bit_el"):
        assert abs(float(port[k]) - float(jint8[k])) <= \
            0.02 * abs(float(jint8[k])), k
    own = _rel_rms(_np(jint8["dpb"]["ref_frame_el"]),
                   _np(jbf16["dpb"]["ref_frame_el"]))
    ours = _rel_rms(_np(port["dpb"]["ref_frame_el"]),
                    _np(jint8["dpb"]["ref_frame_el"]))
    assert 0 < own and ours <= 1.5 * own, (ours, own)
    assert port["dpb"]["ref_frame_el"].dtype == torch.bfloat16


def test_calibrate_video_keys_equal_the_recorder(video_params, table):
    """The port's `calibrate_video` (packed bf16, synthetic frames, seeded
    DPB features) covers the JAX package's keys, every scale positive."""
    got = calibrate.calibrate_video(video_params[1], size=128, frames=1,
                                    device="cpu")
    assert set(got) == set(table) and min(got.values()) > 0


# --- the scheduler (the CLIs' and the bench twin's tests, which share
# this file's fixtures, are in test_torch_int8_stream.py and _bench.py) ----

def _checkpoints(tmp_path):
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    torch.save(init_lssvc(torch.Generator().manual_seed(2)), video)
    return intra, video


def test_scheduler_caches_models_per_table(tmp_path):
    """One model pair per (checkpoint, precision, table content): the same
    table again (another dict, equal content) reuses it, another table
    builds another; int8 models run at packed width 2 with the table,
    the I-frame model too."""
    intra, video = _checkpoints(tmp_path)
    t1 = {"a.3x3": 0.5}
    runner = scheduler.Runner(torch.device("cpu"), None, "int8", t1)
    task = {"i_frame_model_path": str(intra),
            "video_model_path": str(video)}
    first = runner._models(task)
    assert runner._models(dict(task, int8_table=dict(t1))) is first
    second = runner._models(dict(task, int8_table={"a.3x3": 0.25}))
    assert second is not first and len(runner.models) == 2
    for (i_net, v_net), t in ((first, t1), (second, {"a.3x3": 0.25})):
        for net in (i_net, v_net):
            assert net.precision == "int8"
            assert net.mode.packed_width == 2 and net.mode.int8.table == t
            assert net.base_layer_model.mode.int8 is net.mode.int8
