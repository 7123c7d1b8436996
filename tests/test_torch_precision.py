"""The serving precisions of the port (`ops.nn.Mode`: fp32, high, bf16,
bf16_f32out, 1x1 convs as matmuls) against the JAX package's, on the CPU.

Sizes as the other port tests: EL 128x128 / BL 64x64, full channel widths,
the OffsetDiversity cap at the serving 10 px on both sides.  Weights: the
port's own init, through the JAX package's `convert_state_dict` and back
through `params_from_jax`.

Tolerances:
  * the bf16 P-frame: reconstructions and features within 5% relative RMS
    of the JAX package's bf16 forward, bits within 2%, `mv_hat` through
    `assert_close_mostly` at the JAX package's own bf16 closed-loop bound
    (atol 2e-2, rtol 1e-2, 2% of elements: `tests/test_stream_video.py`);
  * the bf16 I-frame: bits within 2%; the BL's reconstruction is chaotic
    in bf16 whoever computes it (a random-init IntraNoAR's latents round
    differently under bf16: the JAX package's own bf16 and fp32 BL
    pictures differ by ~10% relative RMS), so it is held to 1.5x that
    distance, measured in the test, its synthesis from the same latents
    to 5%, and the EL, from the same BL, to 5% and 2% bits;
  * `high` equals `fp32` on the CPU bit for bit (TF32 is a card setting).

The JAX package's modes are process-global: every test that sets one
restores fp32, packed width 1 and no cap in a `finally`, and clears JAX's
caches, so later fp32 parity tests in the same worker run in fp32.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_close_mostly, assert_rel_rms
from lssvc_tpu.convert import convert_state_dict
from lssvc_tpu.models import intra_noar as jin
from lssvc_tpu.models import intra_ss as jis
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.models import lssvc_blocks as jlb
from lssvc_tpu.convert import P as JP
from lssvc_tpu.ops.nn import (
    apply_precision_cli,
    set_od_offset_cap,
    set_packed_width,
    set_precision_mode,
)
from lssvc_tpu_torch import bench
from lssvc_tpu_torch import decode as dec_cli
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.convert import P, params_from_jax
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.harness import runner as trunner
from lssvc_tpu_torch.models import IntraNoAR, IntraSS, LSSVC
from lssvc_tpu_torch.models import lssvc_blocks as tlb
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops.nn import Mode, conv2d, precision_scope
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.tools.synthetic import write_dataset

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)
DPB = ("ref_frame_bl", "ref_frame_el", "ref_feature_bl", "ref_feature_el")
REPO = Path(__file__).resolve().parents[1]
BL_PREFIX = "base_layer_model."


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def video_params():
    jparams = convert_state_dict(init_lssvc(torch.Generator().manual_seed(0)),
                                 jl.LSSVC.TRANSPOSED_CONV_KEYS)
    return jparams, params_from_jax(_np(jparams), "lssvc")


@pytest.fixture(scope="module")
def intra_params():
    jparams = convert_state_dict(
        init_intra_ss(torch.Generator().manual_seed(1), 192))
    return jparams, params_from_jax(_np(jparams), "intra_ss")


@contextlib.contextmanager
def jax_mode(mode):
    """The JAX package in `mode` with the serving cap, then back to fp32,
    packed width 1 and no cap, with its caches cleared."""
    set_precision_mode(mode)
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)
    jax.clear_caches()
    try:
        yield
    finally:
        set_precision_mode("fp32")
        set_packed_width(1)
        set_od_offset_cap(None)
        jax.clear_caches()


def _frame_inputs(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    return [a(*BL, 3), a(*EL, 3), a(*BL, 3), a(*EL, 3), a(*BL, 64),
            a(*EL, 48)]


def _video(tparams, cls=LSSVC, **mode):
    model = cls(tparams, device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING,
                **mode)
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    return model


def _port_frame(tparams, inputs, **mode):
    return _video(tparams, **mode).forward_one_frame(
        *(torch.from_numpy(v) for v in inputs))


def _jax_frame(jparams, inputs):
    return jl._fwd_jit(jparams, *(jnp.asarray(v) for v in inputs), EL, 2.0,
                       (0, 0, 0, 0))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# --- the modes at one conv --------------------------------------------------

def test_conv_in_each_mode(rng):
    """fp32 and high are the same conv on the CPU; bf16 gives a bf16 conv
    of bf16 operands (its bias added inside the conv), and so does int8
    outside its calibrated sites; bf16_f32out an f32 conv of bf16-rounded
    operands, bit for bit; 1x1 convs as matmuls within 1e-5 of the conv;
    the backend flags are restored on exit."""
    x = torch.from_numpy(rng.standard_normal((1, 6, 8, 16), np.float32))
    w3 = torch.from_numpy(rng.standard_normal((8, 16, 3, 3), np.float32))
    w1 = torch.from_numpy(rng.standard_normal((8, 16, 1, 1), np.float32))
    b = torch.from_numpy(rng.standard_normal(8, np.float32))

    def run(mode, w):
        with precision_scope(mode):
            return conv2d(x, w, b)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    ref = run(Mode(), w3)
    assert torch.equal(run(Mode("high"), w3), ref)
    out = run(Mode("bf16"), w3)
    assert out.dtype == torch.bfloat16
    rnd = [t.to(torch.bfloat16).float() for t in (x, w3)]
    exact = torch.nn.functional.conv2d(
        rnd[0].permute(0, 3, 1, 2), rnd[1], b, padding=1).permute(0, 2, 3, 1)
    assert torch.equal(run(Mode("bf16_f32out"), w3), exact)
    assert_rel_rms(out.float().numpy(), exact.numpy(), 1e-2)
    for prec in ("fp32", "bf16"):
        plain = run(Mode(prec), w1)
        mm = run(Mode(prec, conv1x1_einsum=True), w1)
        assert mm.dtype == plain.dtype
        np.testing.assert_allclose(mm.float().numpy(), plain.float().numpy(),
                                   rtol=1e-5 if prec == "fp32" else 2e-2,
                                   atol=1e-5 if prec == "fp32" else 5e-2)
    assert flags == (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    # int8 outside a calibrated packed site is the bf16 conv, bit for bit
    assert torch.equal(run(Mode("int8"), w3), out)
    with pytest.raises(ValueError):
        Mode("int4")


def test_high_equals_fp32_on_cpu(video_params, intra_params):
    """`high` is TF32 on the card; on the CPU it computes plain f32, as the
    JAX package's `high` does on JAX-CPU: bit for bit the fp32 frame."""
    _, tparams = video_params
    inputs = _frame_inputs(3)
    hi = _port_frame(tparams, inputs, precision="high")
    fp = _port_frame(tparams, inputs)
    for k in DPB:
        assert torch.equal(hi["dpb"][k], fp["dpb"][k]), k
    assert torch.equal(hi["bit_el"], fp["bit_el"])
    _, iparams = intra_params
    rng = np.random.default_rng(4)
    x_bl = torch.from_numpy(rng.random((1, *BL, 3), np.float32))
    x_el = torch.from_numpy(rng.random((1, *EL, 3), np.float32))
    outs = []
    for prec in ("high", "fp32"):
        m = IntraSS(iparams, device="cpu", precision=prec)
        m.set_scale_information(2.0, EL, (0, 0, 0, 0))
        outs.append(m.forward(x_bl, x_el))
    for k in ("x_hat_el", "x_hat_bl", "bit_el"):
        assert torch.equal(outs[0][k], outs[1][k]), k


# --- bf16 against the JAX package -------------------------------------------

def test_bf16_p_frame_matches_jax(video_params):
    """The two-layer P-frame in bf16 against the JAX package's bf16
    forward: the same output dtypes, bits within 2%, the DPB within 5%
    relative RMS, mv_hat at the JAX package's bf16 closed-loop bound."""
    jparams, tparams = video_params
    inputs = _frame_inputs(11)
    port = _port_frame(tparams, inputs, precision="bf16")
    with jax_mode("bf16"):
        ref = _jax_frame(jparams, inputs)
    for k in ("bit_bl", "bit_el"):
        assert port[k].dtype == torch.float32 and ref[k].dtype == jnp.float32
        assert abs(float(port[k]) - float(ref[k])) <= 0.02 * float(ref[k])
    for k in DPB:
        assert port["dpb"][k].dtype == torch.bfloat16
        assert ref["dpb"][k].dtype == jnp.bfloat16, k
        assert_rel_rms(_f32(port["dpb"][k]), _f32(ref["dpb"][k]))
    assert_close_mostly(_f32(port["mv_hat"]), _f32(ref["mv_hat"]), atol=2e-2,
                        rtol=1e-2, max_mismatch_frac=0.02)


def test_bf16_i_frame_matches_jax(intra_params):
    """IntraSS in bf16 against the JAX package's bf16 I-frame.

    The BL (IntraNoAR): bits within 2%; its reconstruction within 1.5x the
    JAX package's own bf16-vs-fp32 distance (and 20%), since a random-init
    IntraNoAR's latents round differently under any bf16 rounding (that
    distance is ~10% relative RMS); its synthesis from the JAX package's
    own bf16 latents within 5%.  The EL, from the JAX package's bf16 BL
    outputs: bits within 2%, pictures, latents and features within 5%.
    End to end, the EL inherits the BL's rounding chaos (its bits move by
    a few percent with the BL's picture), so there only the dtypes and the
    BL's bits are held."""
    jparams, tparams = intra_params
    rng = np.random.default_rng(5)
    x_el = rng.random((1, *EL, 3), np.float32)
    x_bl = rng.random((1, *BL, 3), np.float32)
    model = IntraSS(tparams, device="cpu", precision="bf16")
    model.set_scale_information(2.0, EL, (0, 0, 0, 0))
    port = model.forward(torch.from_numpy(x_bl), torch.from_numpy(x_el))
    jbl = {k[len(BL_PREFIX):]: v for k, v in jparams.items()
           if k.startswith(BL_PREFIX)}
    jel = {k: v for k, v in jparams.items() if not k.startswith(BL_PREFIX)}
    bl32 = jin._forward_jit(jbl, jnp.asarray(x_bl))
    with jax_mode("bf16"):
        bl = jin._forward_jit(jbl, jnp.asarray(x_bl))
        el = jis._el_forward(jel, jnp.asarray(x_el), bl["x_hat"], bl["y_hat"],
                             bl["bit"], EL, (0, 0, 0, 0))
    for k, j in (("x_hat_bl", bl["x_hat"]), ("x_hat_el", el["x_hat_el"]),
                 ("feature_el", el["feature_el"])):
        assert port[k].dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert abs(float(port["bit_bl"]) - float(bl["bit"])) \
        <= 0.02 * float(bl["bit"])
    floor = _rel_rms(_f32(bl["x_hat"]), _f32(bl32["x_hat"]))
    got = _rel_rms(_f32(port["x_hat_bl"]), _f32(bl["x_hat"]))
    print(f"BL x_hat: port vs JAX bf16 {got:.4f}, JAX bf16 vs fp32 "
          f"{floor:.4f}")
    assert got <= min(1.5 * floor, 0.2)

    def bf(a):
        return torch.from_numpy(_f32(a)).to(torch.bfloat16)

    with model.scope(), torch.no_grad():
        from lssvc_tpu_torch.models import intra_noar as tin
        from lssvc_tpu_torch.models import intra_ss as tis

        x_hat = tin.g_s(P(model.base_layer_model.flat_params()).sub("g_s"),
                        bf(bl["y_hat"]))
        port_el = tis._el_forward(model.el_params(), torch.from_numpy(x_el),
                                  bf(bl["x_hat"]), bf(bl["y_hat"]), None, EL,
                                  (0, 0, 0, 0))
    assert_rel_rms(_f32(x_hat), _f32(bl["x_hat"]))
    assert abs(float(port_el["bit_el"]) - float(el["bit_el"])) \
        <= 0.02 * float(el["bit_el"])
    for k in ("x_hat_el", "y_hat_el", "feature_el"):
        assert_rel_rms(_f32(port_el[k]), _f32(el[k]))


def test_zero_dim_factors_keep_the_jax_dtype(video_params):
    """torch treats a 0-dim tensor like a Python scalar (bf16 x f32[] ->
    bf16) where JAX promotes (-> f32); JAX's weak Python floats keep bf16.
    The port's scalar factors are Python floats at the site (the resampler's
    scale, OffsetDiversity's magnitude and cap), so a 0-dim tensor handed
    in gives the JAX package's dtype and values, not torch's."""
    half = torch.ones(3, dtype=torch.bfloat16)
    assert (half * torch.tensor(2.0)).dtype == torch.bfloat16
    assert (jnp.ones(3, jnp.bfloat16) * jnp.float32(2.0)).dtype == jnp.float32
    assert (jnp.ones(3, jnp.bfloat16) * 2.0).dtype == jnp.bfloat16
    jparams, tparams = video_params
    rng = np.random.default_rng(6)
    mv_bl = rng.uniform(-2, 2, (1, *BL, 2)).astype(np.float32)
    tp = P(tparams).sub("mv_resampler")
    with precision_scope(Mode("bf16")):
        by_tensor = tlb.mv_resampler(tp, torch.from_numpy(mv_bl), EL,
                                     torch.tensor(2.0))
        by_float = tlb.mv_resampler(tp, torch.from_numpy(mv_bl), EL, 2.0)
    with jax_mode("bf16"):
        ref = jlb.mv_resampler(JP(jparams).sub("mv_resampler"),
                               jnp.asarray(mv_bl), EL, 2.0)
    assert by_tensor.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert torch.equal(by_tensor, by_float)
    assert_rel_rms(_f32(by_tensor), _f32(ref))


# --- bf16 streams -----------------------------------------------------------

def test_bf16_streams_closed_loop(video_params, intra_params, tmp_path):
    """In bf16 the encoders stay closed-loop: the decoder rebuilds the
    encoder's pictures bit for bit, for an I-frame (both layers) and a
    P-frame (both layers)."""
    _, iparams = intra_params
    intra = IntraSS(iparams, device="cpu", precision="bf16")
    intra.set_scale_information(2.0, EL, (0, 0, 0, 0))
    intra.update(force=True)
    rng = np.random.default_rng(7)
    x_bl = torch.from_numpy(rng.random((1, *BL, 3), np.float32))
    x_el = torch.from_numpy(rng.random((1, *EL, 3), np.float32))
    from lssvc_tpu_torch.models.intra_ss_stream import (compress_stream,
                                                        decompress_stream)

    bins = str(tmp_path / "i_bl.bin"), str(tmp_path / "i_el.bin")
    enc = compress_stream(intra, x_bl, x_el, *bins, *BL, *EL)
    dec = decompress_stream(intra, *bins)
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        assert dec[k].dtype == torch.bfloat16
        assert torch.equal(enc[k], dec[k]), k

    _, tparams = video_params
    video = _video(tparams, LSSVCExtend, precision="bf16")
    video.update(force=True)
    dpb = {"ref_frame_bl": torch.clamp(enc["x_hat_bl"], 0, 1),
           "ref_frame_el": torch.clamp(dec["x_hat_el"], 0, 1),
           "ref_feature_bl": None, "ref_feature_el": dec["feature_el"]}
    bl_model = video.base_layer_model
    bl_enc = bl_model.compress(x_bl, dpb)
    bl_dec = bl_model.decompress(bl_enc["string"], *BL, dpb)
    for k in ("ref_frame_bl", "ref_feature_bl", "y_hat_bl", "mv_hat_bl"):
        assert torch.equal(bl_enc["dpb"][k], bl_dec["dpb"][k]), k
    bl = bl_dec["dpb"]
    dpb_el = dict(dpb, texture=bl["ref_feature_bl"], y_hat_bl=bl["y_hat_bl"],
                  mv_hat_bl=bl["mv_hat_bl"])
    el_enc = video.compress(x_el, dpb_el)
    el_dec = video.decompress(el_enc["string"], *EL, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        assert el_dec["dpb"][k].dtype == torch.bfloat16
        assert torch.equal(el_enc["dpb"][k], el_dec["dpb"][k]), k


def _checkpoints(tmp_path):
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    torch.save(init_lssvc(torch.Generator().manual_seed(2)), video)
    return intra, video


def test_cli_bf16_streams_decode_in_a_fresh_process(tmp_path, monkeypatch):
    """`--precision bf16 --write_stream 1` on a 3-frame GOP (I P P), then
    `python -m lssvc_tpu_torch.decode --precision bf16` in a fresh process
    rebuilds the run's EL and BL pictures byte for byte."""
    h, w, frames = 128, 128, 3
    cfg = write_dataset(tmp_path / "ds", h, w, frames=frames, gop=3, seed=5)
    intra, video = _checkpoints(tmp_path)
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = trunner.HostCopy

    def recording(tensors):  # the run's (cropped, clamped) DPB pictures
        for k in pictures:
            pictures[k].append(tensors[k].clone())
        return real_copy(tensors)

    monkeypatch.setattr(trunner, "HostCopy", recording)
    bins = tmp_path / "bins"
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", str(intra),
              "--model_path", str(video), "--output_path",
              str(tmp_path / "out"), "--ratios", "x2", "--device", "cpu",
              "--precision", "bf16", "--write_stream", "1", "--stream_path",
              str(bins)])
    assert all(p.dtype == torch.bfloat16 for p in pictures["x_hat_el"])
    dec = subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bins / "seq1" / "0" / "x2"), "--i_frame_model_path",
         str(intra), "--model_path", str(video), "--height", str(h),
         "--width", str(w), "--ratio", "x2", "--gop", "3", "--frame_num",
         str(frames), "--precision", "bf16", "--yuv_out",
         str(tmp_path / "el.yuv"), "--yuv_out_bl", str(tmp_path / "bl.yuv"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert dec.returncode == 0, dec.stderr
    for layer in ("el", "bl"):
        want = b"".join(yuv_frame(x, (0, 0, 0, 0))
                        for x in pictures[f"x_hat_{layer}"])
        assert (tmp_path / f"{layer}.yuv").read_bytes() == want, layer


def test_clis_refuse_int8(tmp_path):
    """`--precision int8` without a calibration table: both CLIs exit with
    the JAX package's message (its `apply_precision_cli` raises before it
    sets a mode) before they load anything; the int8 path itself is
    tests/test_torch_int8.py's."""
    with pytest.raises(SystemExit) as jax_exit:
        apply_precision_cli("int8", None)
    cfg = write_dataset(tmp_path / "ds", 64, 64, frames=1, gop=1, seed=0)
    base = ["--test_config", str(cfg), "--i_frame_model_path", "i.pth",
            "--model_path", "v.pth", "--output_path", str(tmp_path / "o"),
            "--device", "cpu", "--precision", "int8"]
    with pytest.raises(SystemExit) as port_exit:
        cli.main(base)
    assert str(port_exit.value) == str(jax_exit.value)
    dec = ["--bin_dir", "b", "--i_frame_model_path", "i.pth", "--model_path",
           "v.pth", "--height", "64", "--width", "64", "--frame_num", "1",
           "--yuv_out", "o.yuv", "--device", "cpu", "--precision", "int8"]
    with pytest.raises(SystemExit) as port_exit:
        dec_cli.main(dec)
    assert str(port_exit.value) == str(jax_exit.value)


def test_scheduler_caches_models_per_precision(tmp_path, monkeypatch):
    """One model pair per checkpoint and precision, each built in its
    precision; the same precision again reuses it."""
    intra, video = _checkpoints(tmp_path)
    runner = scheduler.Runner(torch.device("cpu"), None, "bf16")
    task = {"i_frame_model_path": str(intra),
            "video_model_path": str(video)}
    pairs = {prec: runner._models(dict(task, precision=prec))
             for prec in ("bf16", "fp32")}
    assert runner._models(task) is pairs["bf16"]
    assert len(runner.models) == 2
    for prec, (i_net, v_net) in pairs.items():
        assert i_net.precision == v_net.precision == prec
        assert v_net.base_layer_model.precision == prec
        assert i_net.base_layer_model.precision == prec


def _counting_clock(monkeypatch):
    """The bench's clock counts frames, fused and staged (half a second
    each), so its readings agree whatever the load on the host."""
    frames = [0]
    for name in ("forward_one_frame", "forward_one_frame_staged3"):
        real = getattr(LSSVC, name)

        def counted(self, *args, real=real):
            frames[0] += 1
            return real(self, *args)

        monkeypatch.setattr(LSSVC, name, counted)

    class Clock:
        @staticmethod
        def perf_counter():
            return 0.5 * frames[0]

    monkeypatch.setattr(bench, "time", Clock)


def test_bench_twin_runs_on_the_cpu(monkeypatch, capsys):
    """`python -m lssvc_tpu_torch.bench` at 128x128, one fp32 and one
    bf16_packed chain of K=1 frames, prints the root bench's JSON keys.
    The clock counts frames (half a second each), so the readings agree
    whatever the load on the host."""
    _counting_clock(monkeypatch)
    for mode in ("fp32", "bf16_packed"):
        line = bench.main(["--mode", mode, "--device", "cpu", "--size",
                           "128x128", "--frames", "1"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == line
        assert line["metric"] == "two_layer_128x128_fps_per_chip"
        assert line["unit"] == "frames/s" and line["mode"] == mode
        assert line["s_per_frame"] == 0.5 and line["value"] == 2.0
        assert line["vs_baseline"] == pytest.approx(2.0 * (1.44 + 1.35))
        assert np.isfinite(line["bits"]) and line["bits"] > 0
    for argv in (["--staged"], ["--tier-stats"]):  # ported: they run
        line = bench.main(argv + ["--device", "cpu", "--size", "128x128",
                                  "--frames", "1"])
        assert line["staged"] == (argv == ["--staged"])
        assert line["s_per_frame"] == 0.5


def test_bench_twin_defaults_to_bf16_packed(monkeypatch, capsys):
    """No --mode: the root bench's default, `bf16_packed`
    (`bench.py:355-357`); `bench_chain`'s own default stays `bf16`."""
    _counting_clock(monkeypatch)
    line = bench.main(["--device", "cpu", "--size", "128x128", "--frames",
                       "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    assert line["mode"] == "bf16_packed" and line["staged"] is False
    assert bench.bench_chain.__defaults__[2] == "bf16"


@pytest.mark.parametrize("argv", [["--staged", "--frames", "3"],
                                  ["--batch", "2", "--frames", "3"]])
def test_bench_twin_staged_caps_k(monkeypatch, argv):
    """`--staged`, or `--batch` 2, takes the four-stage frame with K
    capped at 2 (`bench.py:133-138`)."""
    _counting_clock(monkeypatch)
    line = bench.main(argv + ["--device", "cpu", "--size", "128x128",
                              "--mode", "fp32"])
    assert line["staged"] is True and line["frames"] == 2
    assert line["batch"] == (2 if "--batch" in argv else 1)
    assert line["fps"] == line["batch"] / 0.5
    assert np.isfinite(line["bits"]) and line["bits"] > 0


def test_bench_twin_tier_stats(monkeypatch, capsys):
    _counting_clock(monkeypatch)
    bench.main(["--tier-stats", "--device", "cpu", "--size", "128x128",
                "--frames", "1", "--mode", "fp32"])
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("# tier-stats")]
    assert [ln.split(":")[0] for ln in lines] == [
        f"# tier-stats frame {i}" for i in (1, 2, 3)]
    assert all("-> EL warp tier: " in ln and "label" in ln for ln in lines)


@pytest.mark.parametrize("mv, tier", [
    ((2.0, 2.0), "tiny"), ((2.01, 0.0), "windowed"), ((0.0, 2.01), "windowed"),
    ((62.0, 26.0), "windowed"), ((62.01, 0.0), "fallback"),
    ((0.0, 26.01), "fallback")])
def test_bench_warp_tier_label(mv, tier):
    assert bench.warp_tier(*mv) == tier
