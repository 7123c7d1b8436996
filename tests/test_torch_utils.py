"""The port's host-side utilities against the JAX package's.

Inter-layer padding at every ratio, the MATLAB-bicubic `imresize` (f32
within 1e-5 of the output's largest magnitude; integer saturation exact),
colour conversion, the YUV reader, the quality metrics and the result-log
aggregation, each on the same arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lssvc_tpu.harness import results as jres
from lssvc_tpu.harness.runner import RATIO_FACTORS as J_RATIO_FACTORS
from lssvc_tpu.utils import color as jcolor
from lssvc_tpu.utils import io as jio
from lssvc_tpu.utils import metrics as jmetrics
from lssvc_tpu.utils import msssim_rgb as jmsssim
from lssvc_tpu.utils import padding as jpad
from lssvc_tpu.utils import resize as jresize
from lssvc_tpu_torch.harness import results as tres
from lssvc_tpu_torch.harness.runner import RATIO_FACTORS
from lssvc_tpu_torch.utils import color as tcolor
from lssvc_tpu_torch.utils import io as tio
from lssvc_tpu_torch.utils import metrics as tmetrics
from lssvc_tpu_torch.utils import msssim_rgb as tmsssim
from lssvc_tpu_torch.utils import padding as tpad
from lssvc_tpu_torch.utils import resize as tresize

from torch_threads import share_cores

share_cores()


def test_ratio_factors_equal():
    assert RATIO_FACTORS == J_RATIO_FACTORS


@pytest.mark.parametrize("ratio", sorted(J_RATIO_FACTORS))
@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (104, 120),
                                (287, 353)])
def test_interlayer_padding_equal(hw, ratio):
    h, w = hw
    scale = J_RATIO_FACTORS[ratio]
    ref = jpad.get_interlayer_padding(H_HR=h, W_HR=w, ratio=scale)
    out = tpad.get_interlayer_padding(H_HR=h, W_HR=w, ratio=scale)
    assert out == ref
    assert tpad.inverse_padding_size(out["P_HR"]) == \
        jpad.inverse_padding_size(ref["P_HR"])
    assert tpad.get_padding_size(h, w) == jpad.get_padding_size(h, w)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((128, 128), (64, 64)),      # x2 down, antialiased
    ((97, 131), (39, 52)),       # odd sizes, non-integer down
    ((33, 47), (70, 99)),        # odd sizes, up
    ((64, 96), (96, 144)),       # x1.5 up
])
def test_imresize_matches_jax(rng, in_hw, out_hw):
    x = rng.random((1, 3, *in_hw), dtype=np.float32)
    ref = np.asarray(jresize.imresize(jnp.asarray(x), sizes=out_hw))
    out = tresize.imresize(torch.from_numpy(x), sizes=out_hw)
    assert out.dtype == torch.float32 and out.shape == (1, 3, *out_hw)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    # the same by scale, and on a 2-D array
    if out_hw[0] / in_hw[0] == out_hw[1] / in_hw[1]:
        scale = out_hw[0] / in_hw[0]
        by_scale = tresize.imresize(torch.from_numpy(x[0, 0]), scale=scale)
        np.testing.assert_allclose(by_scale.numpy(), out.numpy()[0, 0],
                                   rtol=0, atol=1e-6)


def test_imresize_keeps_full_f32_with_tf32_on(rng):
    """Whatever the global TF32 setting, the resize runs in full f32 and
    restores the setting."""
    x = rng.random((1, 3, 40, 40), dtype=np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = tresize.imresize(torch.from_numpy(x), sizes=(20, 20))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    ref = np.asarray(jresize.imresize(jnp.asarray(x), sizes=(20, 20)))
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5


@pytest.mark.parametrize("dtype,tdtype,top", [
    (np.uint8, torch.uint8, 255), (np.uint16, torch.uint16, 65535)])
def test_imresize_integer_saturation_exact(rng, dtype, tdtype, top):
    """Bicubic overshoot at the hard edges of a 0/top noise image saturates
    to [0, top] instead of wrapping, as in the JAX package: every saturated
    value equals the JAX package's exactly, and so does every uint8 value.
    A uint16 value in between may differ by 1, where the two frameworks'
    f32 sums (rounding error ~4e-3 at 65535) land on either side of a .5.
    (Noise, not a symmetric pattern: symmetric weights put uint8 values on
    exact .5 ties.)"""
    x = (rng.random((2, 24, 26)) < 0.5).astype(dtype) * dtype(top)
    for sizes in ((12, 13), (37, 41)):
        ref = np.asarray(jresize.imresize(jnp.asarray(x), sizes=sizes))
        out = tresize.imresize(torch.from_numpy(x.astype(np.int32)).to(tdtype),
                               sizes=sizes)
        assert out.dtype == tdtype
        out = out.to(torch.int32).numpy()
        saturated = (ref == 0) | (ref == top)
        np.testing.assert_array_equal(out[saturated], ref[saturated])
        np.testing.assert_array_equal(saturated, (out == 0) | (out == top))
        assert np.max(np.abs(out - ref.astype(np.int32))) <= (
            0 if dtype == np.uint8 else 1)
        f32 = tresize.imresize(torch.from_numpy(x.astype(np.float32)),
                               sizes=sizes)
        # the f32 resize overshoots both ends; the integer one saturates
        assert float(f32.max()) > top and float(f32.min()) < 0
        assert ref.max() == top and ref.min() == 0


def test_imresize_int32_saturates_to_its_range():
    """f32 rounds the bound 2^31 - 1 up to 2^31, out of range: the port
    clamps in f64, so the overshoot saturates where the JAX package's does
    (XLA's conversion saturates); the undershoot, in range, stays."""
    x = np.zeros((20, 20), dtype=np.int32)
    x[:, 10:] = 2 ** 31 - 1
    ref = np.asarray(jresize.imresize(jnp.asarray(x), sizes=(31, 31)))
    out = tresize.imresize(torch.from_numpy(x), sizes=(31, 31))
    assert out.dtype == torch.int32
    out = out.numpy()
    # (which pixels saturate can differ: near 2^31 an f32 ulp is 256, and
    # the frameworks' sums round either way)
    assert out.max() == ref.max() == 2 ** 31 - 1
    assert -2 ** 30 < out.min() < 0 and ref.min() < 0


def test_color_round_trip_equal(rng):
    rgb = rng.random((3, 32, 48), dtype=np.float32)
    y, uv = tcolor.rgb_to_ycbcr420(rgb)
    jy, juv = jcolor.rgb_to_ycbcr420(rgb)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    for order in (0, 1):
        np.testing.assert_array_equal(tcolor.ycbcr420_to_rgb(y, uv, order),
                                      jcolor.ycbcr420_to_rgb(jy, juv, order))


def test_yuv_reader_equal(tmp_path, rng):
    h, w, n = 16, 24, 3
    path = tmp_path / "seq.yuv"
    path.write_bytes(rng.integers(0, 256, n * h * w * 3 // 2,
                                  dtype=np.uint8).tobytes()
                     + b"\x00" * 10)  # a truncated frame ends the sequence
    mine, ref = tio.YUVReader(str(path), w, h), jio.YUVReader(str(path), w, h)
    for _ in range(n):
        (y, uv), (jy, juv) = mine.read_one_frame(), ref.read_one_frame()
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(uv, juv)
    assert mine.read_one_frame() == (None, None)
    mine.close()
    ref.close()


def test_metrics_equal(rng):
    a = rng.random((200, 184), dtype=np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0, 1)
    assert tmetrics.calc_msssim(a, b, data_range=1) == \
        jmetrics.calc_msssim(a, b, data_range=1)
    for mine, ref in zip(tmetrics.calc_ssim(a, b, data_range=1),
                         jmetrics.calc_ssim(a, b, data_range=1)):
        np.testing.assert_array_equal(mine, ref)
    for mse in (1e-3, 1e-12, float("nan")):
        np.testing.assert_equal(tmetrics.mse_to_psnr(mse),
                                jmetrics.mse_to_psnr(mse))
    rgb_a = rng.random((3, 192, 176), dtype=np.float32)
    rgb_b = np.clip(rgb_a + 0.05 * rng.normal(size=rgb_a.shape), 0, 1) \
        .astype(np.float32)
    for win in (7, 11):
        assert tmsssim.ms_ssim_rgb(rgb_a, rgb_b, win_size=win, data_range=1) \
            == jmsssim.ms_ssim_rgb(rgb_a, rgb_b, win_size=win, data_range=1)


def test_aggregate_layer_log_equal(rng):
    def frames(mod):
        return [mod.FrameMetrics(float(b), *map(float, rng.random(7)))
                for b in rng.random(5) * 1e4]

    types = [0, 1, 1, 0, 1]
    fr = frames(tres)
    jfr = [jres.FrameMetrics(*(getattr(f, s) for s in f.__slots__))
           for f in fr]
    for kw in ({}, {"include_yuv_list": False,
                    "bits_override": [f.bit * 2 for f in fr]}):
        out = tres.aggregate_layer_log(fr, types, 64 * 64, 1.5, 0.0, 0.0, **kw)
        ref = jres.aggregate_layer_log(jfr, types, 64 * 64, 1.5, 0.0, 0.0,
                                       **kw)
        assert out == ref
        assert tres.filter_dict(out) == jres.filter_dict(ref)
    assert tres.RESULT_KEYS == jres.RESULT_KEYS
