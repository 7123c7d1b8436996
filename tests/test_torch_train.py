"""The port's trainer against the JAX package's, on the CPU: the optimizer
(optax's Adam, `multi_transform` freeze and cosine schedule), whole train
steps, the data generators, the checkpoints across packages and the CLI
(`python -m lssvc_tpu_torch.train`).

The optimizer is held bit for bit on the same numpy gradients, but for the
cosine schedule's rate: XLA's f32 cosine is an approximation of its own
(faithful, not correctly rounded), so the port's rate, the float64 cosine
rounded to f32, is held within one f32 ulp, and an update bit-equal where
the two rates are equal.  Whole train steps are compared by their loss
only (Adam's first update is about +-lr whatever the gradient).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import train as jax_train_cli
from lssvc_tpu import checkpoint as jckpt
from lssvc_tpu.models import intra_noar as j_intra_noar
from lssvc_tpu.models.base import label_params as j_label_params
from lssvc_tpu.models.init import (init_dmc, init_intra_noar, init_intra_ss,
                                   init_lssvc)
from lssvc_tpu.ops import nn as jnn
from lssvc_tpu.parallel import train as jtrain
from lssvc_tpu_torch import checkpoint as tckpt
from lssvc_tpu_torch import train as tcli
from lssvc_tpu_torch.convert import params_from_jax, params_to_jax
from lssvc_tpu_torch.models import intra_noar as t_intra_noar
from lssvc_tpu_torch.models.base import label_params
from lssvc_tpu_torch.models.init import init_cheng2020
from lssvc_tpu_torch.ops import nn as tnn
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.parallel import train as ttrain

from parity_utils import assert_close_mostly
from test_torch_train_grads import check_loss_and_gradients
from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def jax_fp32():
    """The JAX package's process-wide modes as its train step runs them,
    restored after."""
    jnn.set_precision_mode("fp32")
    jnn.set_packed_width(1)
    jnn.set_od_offset_cap(None)
    try:
        yield
    finally:
        jnn.set_precision_mode("fp32")
        jnn.set_packed_width(1)
        jnn.set_od_offset_cap(None)


KEYS = {"optic_flow.moduleBasic.0.conv1.weight": (4, 3, 3, 3),
        "mv_encoder.encoder1.0.bias": (7,),
        "res_encoder.conv1.weight": (5, 2, 3, 3),
        "bit_estimator_z.f1.h": (1, 6, 1, 1)}


def _grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in KEYS.items()}


def _params():
    rng = np.random.default_rng(7)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in KEYS.items()}


def _run_optax(tx, steps=3):
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(params)
    out = []
    for i in range(steps):
        grads = {k: jnp.asarray(v) for k, v in _grads(i).items()}
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        out.append(({k: np.asarray(v) for k, v in upd.items()},
                    {k: np.asarray(v) for k, v in params.items()}))
    return out


def _run_port(opt, steps=3):
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    state = opt.init(params)
    out = []
    for i in range(steps):
        grads = {k: torch.from_numpy(v) for k, v in _grads(i).items()}
        upd, state = opt.update(grads, state, params)
        params = ttrain.apply_updates(params, upd)
        out.append(({k: v.numpy() for k, v in upd.items()},
                    {k: v.numpy() for k, v in params.items()}))
    return out


def _assert_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes(), float(np.abs(a - b).max())


@pytest.mark.parametrize("lr", [1e-4, 3e-3])
def test_adam_is_bit_equal_to_optax(lr):
    ref = _run_optax(optax.adam(lr))
    got = _run_port(ttrain.Adam(lr))
    for (u_r, p_r), (u_g, p_g) in zip(ref, got):
        for k in KEYS:
            _assert_bits(u_g[k], u_r[k])
            _assert_bits(p_g[k], p_r[k])


@pytest.mark.parametrize("frozen", ["prediction", "other"])
def test_freeze_is_bit_equal_to_optax_multi_transform(frozen):
    """`train.py`'s multi_transform: set_to_zero for the frozen label, Adam
    for the other, whose state holds only its keys."""
    lr = 1e-4
    labels = j_label_params(_params())
    assert labels == label_params(_params())
    assert set(labels.values()) == {"prediction", "other"}
    tx = optax.multi_transform(
        {"prediction": (optax.set_to_zero() if frozen == "prediction"
                        else optax.adam(lr)),
         "other": (optax.set_to_zero() if frozen == "other"
                   else optax.adam(lr))}, labels)
    opt = ttrain.Adam(lr, labels=labels, frozen=frozen)
    ref, got = _run_optax(tx), _run_port(opt)
    assert set(opt.init({k: torch.from_numpy(v) for k, v in
                         _params().items()})["mu"]) == {
        k for k, v in labels.items() if v != frozen}
    for (u_r, p_r), (u_g, p_g) in zip(ref, got):
        for k in KEYS:
            if labels[k] == frozen:
                assert k not in u_g and not np.any(u_r[k])
            else:
                _assert_bits(u_g[k], u_r[k])
            _assert_bits(p_g[k], p_r[k])


def test_cosine_schedule_matches_optax():
    """Rates within one f32 ulp of optax's at every count (bit-equal at
    most); Adam under the schedule bit-equal to optax where the rates are
    equal, within one ulp where they are not."""
    lr, steps = 1e-4, 40
    ref_s = optax.cosine_decay_schedule(lr, steps, alpha=0.01)
    got_s = ttrain.cosine_decay_schedule(lr, steps, alpha=0.01)
    equal = 0
    for c in range(steps + 5):
        r = np.float32(ref_s(jnp.int32(c)))
        g = np.float32(got_s(c))
        assert abs(g - r) <= np.spacing(r), (c, g, r)
        equal += g == r
    assert equal >= 0.9 * (steps + 5), equal
    ref = _run_optax(optax.adam(ref_s))
    got = _run_port(ttrain.Adam(got_s))
    for i, ((u_r, _), (u_g, _)) in enumerate(zip(ref, got)):
        same_rate = np.float32(ref_s(jnp.int32(i))) == np.float32(got_s(i))
        for k in KEYS:
            if same_rate:
                _assert_bits(u_g[k], u_r[k])
            else:
                np.testing.assert_allclose(u_g[k], u_r[k], rtol=2.4e-7)


def test_train_steps_match_jax_by_loss():
    """Two whole `spynet` steps (gradient, Adam, update) from the same
    weights and batches: the losses within 1e-3 relative."""
    crop = 128
    jparams = init_lssvc(seed=0)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             "lssvc")
    data = tcli.SyntheticPairs(crop, 0)
    batches = [tcli.make_batch(data, "spynet", 1, 2, "cpu")[0]
               for _ in range(3)]
    jstep = jax.jit(jtrain.make_train_step(optax.adam(1e-4), 0.01,
                                           (crop, crop), loss="spynet"))
    jstate = optax.adam(1e-4).init(jparams)
    opt = ttrain.Adam(1e-4)
    tstep = ttrain.make_train_step(opt, 0.01, (crop, crop), loss="spynet")
    tstate = opt.init(params)
    for b in batches:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v.numpy())
                                     for k, v in b.items()})
        params, tstate, tm = tstep(params, tstate, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
    assert tstate["count"] == 3


@pytest.mark.parametrize("loss", ["spynet", "cascade", "intra"])
def test_loss_and_gradients_match_jax(loss):
    """The losses `test_torch_train_grads.py` does not hold (cascade: T=3,
    one warm step)."""
    check_loss_and_gradients(loss)


# ---------------------------------------------------------------------------
# Data

@pytest.mark.parametrize("scan_steps", [1, 8])
def test_synthetic_draws_equal_train_py(scan_steps):
    """The port's generator draws what train.py's draws, for the per-step
    (K = 1) and the chunked (K = 8: one call for 8 steps) orders, pairs
    and cascade sequences."""
    crop, batch = 128, 2
    ref = jax_train_cli.SyntheticPairs(crop, seed=3)
    got = tcli.SyntheticPairs(crop, seed=3)
    for _ in range(2 if scan_steps == 1 else 1):
        for a, b in zip(ref.next_batch(scan_steps * batch),
                        got.next_batch(scan_steps * batch)):
            _assert_bits(b, a)
    _assert_bits(got.next_sequences(batch, 3), ref.next_sequences(batch, 3))


def _write_yuv(path, w, h, frames, seed):
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(rng.integers(0, 256, frames * w * h * 3 // 2,
                                  dtype=np.uint8).tobytes())


@pytest.mark.parametrize("scan_steps", [1, 8])
def test_yuv_draws_equal_train_py(tmp_path, scan_steps):
    w, h = 48, 32
    _write_yuv(tmp_path / "a" / "s1.yuv", w, h, 5, 0)
    _write_yuv(tmp_path / "b" / "s2.yuv", w, h, 2, 1)
    (tmp_path / "short.yuv").write_bytes(b"\0" * 10)  # skipped by both
    ref = jax_train_cli.YUVPairs(str(tmp_path), w, h, 16, seed=4)
    got = tcli.YUVPairs(str(tmp_path), w, h, 16, seed=4)
    assert got.files == ref.files and len(got.files) == 2
    for _ in range(2 if scan_steps == 1 else 1):
        for a, b in zip(ref.next_batch(scan_steps), got.next_batch(scan_steps)):
            _assert_bits(b, a)
    _assert_bits(got.next_sequences(2, 3), ref.next_sequences(2, 3))


# ---------------------------------------------------------------------------
# Checkpoints

def _jax_models():
    chengs = params_to_jax(init_cheng2020(torch.Generator().manual_seed(0),
                                          32), "cheng2020")
    return {"dmc": init_dmc(seed=0), "lssvc": init_lssvc(seed=0),
            "intra_noar": init_intra_noar(N=32), "intra_ss": init_intra_ss(),
            "cheng2020": chengs}


@pytest.mark.parametrize("model", ["dmc", "lssvc", "intra_noar", "intra_ss",
                                   "cheng2020"])
def test_params_to_jax_inverts_params_from_jax(model):
    p = {k: np.asarray(v) for k, v in _jax_models()[model].items()}
    back = params_to_jax(params_from_jax(p, model), model)
    assert set(back) == set(p)
    for k, v in p.items():
        _assert_bits(back[k], v)
        assert back[k].flags["C_CONTIGUOUS"]


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-written .npz (the port's own init) loads in the JAX package's
    `load_params`, and JAX's forward on it equals the port's."""
    from lssvc_tpu_torch.models.init import init_intra_noar as t_init

    params = t_init(torch.Generator().manual_seed(5), N=32)
    path = str(tmp_path / "noar_step3.npz")
    tckpt.save_params(path, params, "intra_noar", metadata={"step": 3})
    jparams, meta = jckpt.load_params(path)
    assert int(meta["step"]) == 3 and set(jparams) == set(params)
    x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    j = j_intra_noar.forward(jparams, jnp.asarray(x))
    with tnn.precision_scope(tnn.Mode("fp32")):
        t = t_intra_noar.forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(float(t["bit"]), float(j["bit"]), rtol=1e-3)
    assert_close_mostly(t["x_hat"].numpy(), np.asarray(j["x_hat"]))


def test_jax_train_state_loads_in_port_params_only(tmp_path):
    jparams = init_intra_noar(N=32)
    opt_state = optax.adam(1e-4).init(jparams)
    path = str(tmp_path / "run_step7.state.npz")
    jckpt.save_train_state(path, jparams, opt_state, 7, out_tag="run")
    params, state, step = tckpt.load_train_state(path, "intra_noar")
    assert state is None and step == 7
    want = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                           "intra_noar")
    assert set(params) == set(want)
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    assert str(tckpt.read_ckpt_meta(path)["out_tag"]) == "run"


def test_port_train_state_round_trips_and_jax_reads_its_params(tmp_path):
    params = params_from_jax({k: np.asarray(v) for k, v in
                              init_intra_noar(N=32).items()}, "intra_noar")
    labels = {k: ("prediction" if k.startswith("g_a.") else "other")
              for k in params}
    opt = ttrain.Adam(1e-4, labels=labels, frozen="other")
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    _, state = opt.update(grads, state, params)
    path = str(tmp_path / "run_step1.state.npz")
    tckpt.save_train_state(path, params, "intra_noar", state, 1,
                           out_tag="run")
    p2, s2, step = tckpt.load_train_state(path, "intra_noar")
    assert step == 1 and s2["count"] == 1
    assert set(s2["mu"]) == set(state["mu"])
    for part in ("mu", "nu"):
        for k, v in state[part].items():
            assert torch.equal(s2[part][k], v)
    for k, v in params.items():
        assert torch.equal(p2[k], v)
    jparams, meta = jckpt.load_params(path)  # skips the __opt__ entries
    assert set(jparams) == set(params) and int(meta["step"]) == 1
    assert int(meta["n_opt"]) == 1 + 2 * len(state["mu"])


@pytest.mark.parametrize("tag,step0,out,steps", [
    ("runs/a", 120, "runs/a", 400),    # same run, mid-way: crash
    ("runs/full", 2400, "runs/cascade", 1200),  # another stage
    ("", 2400, "runs/cascade", 1200),  # untagged, past --steps: stage
    ("", 100, "runs/cascade", 1200),   # untagged, mid-way: crash
    ("runs/a", 400, "runs/a", 400)])   # same run, finished: crash
def test_resume_policy_matches_train_py(tag, step0, out, steps):
    want = jax_train_cli.resume_policy(tag, step0, out, steps)
    assert tcli.resume_policy(tag, step0, out, steps) == want
    assert want == ("crash" if (tag == out or (not tag and step0 < steps))
                    else "stage")


# ---------------------------------------------------------------------------
# The CLI

def test_cli_takes_every_flag_of_train_py(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py"])
    ref = vars(jax_train_cli.parse_args())
    got = vars(tcli.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == ref


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "lssvc_tpu_torch.train", "--device", "cpu",
         "--data", "synthetic", "--crop", "128", "--scan-steps", "1",
         "--log-every", "1", *args], cwd=REPO, capture_output=True,
        text=True, check=True, env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_cli_trains_saves_resumes_and_skips(tmp_path):
    out = str(tmp_path / "ck" / "lssvc")
    log = _cli("--steps", "2", "--save-every", "1", "--out", out).stdout
    assert "step 1: loss=" in log and "step 2: loss=" in log
    for s in (1, 2):
        assert Path(f"{out}_step{s}.npz").exists()
        assert Path(f"{out}_step{s}.state.npz").exists()
    model = scheduler.load_video(f"{out}_step2.npz", "cpu", None)
    jparams, meta = jckpt.load_params(f"{out}_step2.npz")
    assert int(meta["step"]) == 2
    assert set(jparams) == set(model.state_dict())
    # a crash resume restores the optimizer and the step
    log = _cli("--steps", "3", "--save-every", "5", "--out", out, "--resume",
               f"{out}_step2.npz").stdout
    assert "restored optimizer state + step 2" in log
    assert "step 3: loss=" in log and "step 1:" not in log
    meta = tckpt.read_ckpt_meta(f"{out}_step3.state.npz")
    assert int(meta["step"]) == 3 and str(meta["out_tag"]) == out
    # done: nothing to train
    log = _cli("--steps", "3", "--out", out, "--skip-if-done").stdout
    assert "exists; --skip-if-done -> nothing to do" in log


def test_cli_intra_checkpoint_loads(tmp_path):
    out = str(tmp_path / "intra")
    _cli("--loss", "intra", "--steps", "1", "--out", out)
    model = scheduler.load_intra(f"{out}_step1.npz", "cpu")
    jparams, meta = jckpt.load_params(f"{out}_step1.npz")
    assert int(meta["step"]) == 1
    assert set(jparams) == set(model.state_dict())


def test_warp_packed_store_refuses_grad():
    from lssvc_tpu_torch.ops import warp_kernels as wk

    x = torch.rand(1, 4, 6, 3, requires_grad=True)
    flow = torch.zeros(1, 4, 6, 2)
    with pytest.raises(RuntimeError, match="no gradient"):
        wk.flow_warp(x, flow, packed_out=True)
    with torch.no_grad():
        assert wk.flow_warp(x, flow, packed_out=True).shape == (1, 4, 3, 6)
