"""The port's data parallelism (`lssvc_tpu_torch/parallel/{mesh,train,
serve}.py`, the trainer under torchrun, `dryrun.py`) on gloo ranks.

- `make_mesh` refuses nccl with more ranks than cards, naming
  `--backend gloo`, and needs a rank and world from somewhere.
- A toy model's data-parallel Adam steps, from rank 0's parameters
  (`replicate`), against the JAX package's sharded step
  (`tests/test_parallel.py:18-48`, there with optax.adam).
- The data-parallel gradient of the `pair` loss on 2 ranks (one item
  each) against the one-process gradient of the global batch of 2, in
  float64: the whole gradient within 1e-4 relative L2 (printed); Adam's
  update from it leaves the parameters and moments bit-equal across the
  ranks.
- `serve_streams`, two streams on two ranks, bit-equal to each stream run
  alone.
- `python -m lssvc_tpu_torch.train` under a world of 1, bit-equal to the
  plain run's checkpoint, and under a world of 2 against one process with
  batch 2.
- The dry run's `entry()` and `python -m lssvc_tpu_torch.dryrun --n 2
  --device cpu`.

Each reference runs in a process of its own with a rank's thread count
(`torch_dist.run(..., group=False)`), so that bit-equality does not hang
on the CPU's thread count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dist
from lssvc_tpu.parallel.mesh import make_mesh as j_make_mesh
from lssvc_tpu.parallel.mesh import replicate as j_replicate
from lssvc_tpu.parallel.mesh import shard_batch as j_shard_batch
from lssvc_tpu_torch import dryrun
from lssvc_tpu_torch.checkpoint import load_params
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.parallel import mesh

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)


def test_make_mesh_refuses_nccl_past_the_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--backend gloo"):
        mesh.make_mesh(backend="nccl", rank=0, world=2,
                       init_method=f"file://{tmp_path}/store")
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh(device="cpu")
    assert not torch.distributed.is_initialized()
    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"


def test_shard_batch_without_a_group():
    x = torch.arange(12.0).reshape(4, 3)
    assert mesh.shard_batch({"x": x, "lmbda": 0.01})["x"] is not None
    assert torch.equal(mesh.shard_batch(x), x)
    assert mesh.world_of() == (0, 1)


def _toy():
    rng = np.random.default_rng(0)
    params = {"w": np.ones((4, 4), np.float32),
              "b": np.zeros((4,), np.float32)}
    batch = {"x": rng.random((16, 4, 4)).astype(np.float32),
             "y": rng.random((16, 4, 4)).astype(np.float32)}
    return params, batch


def test_toy_data_parallel_step_matches_jax(tmp_path):
    """Three Adam steps of the toy loss on 2 ranks (8 rows each) against
    the JAX package's sharded step over a 2-device mesh."""
    params, batch = _toy()
    m = j_make_mesh(2)
    opt = optax.adam(0.1)

    def loss_fn(p, b):
        pred = b["x"] @ p["w"] + p["b"]
        return jnp.mean(jnp.square(pred - b["y"]))

    def step(p, s, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    repl, data = j_replicate(m), j_shard_batch(m)
    sharded = jax.jit(step, in_shardings=(repl, repl,
                                          {"x": data, "y": data}),
                      out_shardings=(repl, repl, repl))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = opt.init(p)
    for _ in range(3):
        p, s, loss = sharded(p, s, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    ranks = torch_dist.run(torch_dist.toy_steps, 2, tmp_path, params, batch,
                           0.1, 3)
    for got, metrics in ranks:
        for k in p:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(p[k]),
                                       rtol=1e-6, atol=1e-6)
        assert abs(float(metrics["loss"]) - float(loss)) < 1e-6
    for k in p:  # replicated: bit-equal on both ranks
        assert torch.equal(ranks[0][0][k], ranks[1][0][k])


def _pair_batch(n, seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.random((n, *shape), np.float32)

    return {"x_bl": a(*BL, 3), "x_el": a(*EL, 3), "ref_bl": a(*BL, 3),
            "ref_el": a(*EL, 3)}


def test_data_parallel_gradient_matches_the_global_batch(tmp_path):
    """2 ranks, one item each, against one process on both items, in
    float64: at random init the f32 gradient's keys are cancelling sums
    whose last digits follow the summation order (the batch's items summed
    inside each conv against two ranks' sums averaged: 1.03e-4 relative L2
    in f32), so f64 isolates the data-parallel arithmetic."""
    params = {k: v.numpy() for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    batch = _pair_batch(2)
    ranks = torch_dist.run(torch_dist.dp_grads, 2, tmp_path, params, batch,
                           "pair")
    (metrics, ref), = torch_dist.run(torch_dist.global_grads, 1, tmp_path,
                                     params, batch, EL, group=False,
                                     threads_of=2)
    # rank r took rows [r, r+1) of the global batch
    for r, got in enumerate(ranks):
        assert got["rows"] == 1
        assert torch.equal(got["first_row"],
                           torch.from_numpy(batch["x_el"][r:r + 1, 0, 0, 0]))
        assert got["equal"], f"rank {r}: train state differs across ranks"
    got = ranks[0]["grads"]
    flat = torch.cat([got[k].reshape(-1) for k in sorted(ref)]).double()
    want = torch.cat([ref[k].reshape(-1) for k in sorted(ref)]).double()
    rel = float(torch.linalg.vector_norm(flat - want)
                / torch.linalg.vector_norm(want))
    print(f"data-parallel gradient: relative L2 {rel:.3e}, max |diff| "
          f"{float((flat - want).abs().max()):.3e} of max "
          f"{float(want.abs().max()):.3e}")
    assert rel < 1e-4
    for k in metrics:
        assert abs(float(ranks[0]["metrics"][k]) - float(metrics[k])) \
            <= 1e-4 * max(abs(float(metrics[k])), 1.0), k
    for k in ranks[0]["metrics"]:
        assert float(ranks[0]["metrics"][k]) == float(ranks[1]["metrics"][k])


def test_serve_streams_equals_each_stream_alone(tmp_path):
    params = {k: v.numpy() for k, v in
              init_lssvc(torch.Generator().manual_seed(1)).items()}
    rng = np.random.default_rng(2)
    t, b = 2, 2
    frames_bl = rng.random((t, b, *BL, 3), np.float32)
    frames_el = rng.random((t, b, *EL, 3), np.float32)
    dpb0 = {"ref_frame_bl": rng.random((b, *BL, 3), np.float32),
            "ref_frame_el": rng.random((b, *EL, 3), np.float32),
            "ref_feature_bl": rng.random((b, *BL, 64), np.float32),
            "ref_feature_el": rng.random((b, *EL, 48), np.float32)}
    ranks = torch_dist.run(torch_dist.serve, 2, tmp_path, params, frames_bl,
                           frames_el, dpb0, EL)
    (alone,) = torch_dist.run(torch_dist.streams_alone, 1, tmp_path, params,
                              frames_bl, frames_el, dpb0, EL, group=False,
                              threads_of=2)
    for r, got in enumerate(ranks):
        assert got["bits"].shape == (t, b, 2)
        assert torch.equal(got["bits"], ranks[0]["bits"])
        assert torch.equal(got["bits"][:, r], alone[r]["bits"])
        for k in dpb0:
            assert torch.equal(got["dpb"][k], alone[r]["dpb"][k]), (r, k)


def _argv(out, batch, steps=2):
    return ["--device", "cpu", "--crop", "128", "--steps", str(steps),
            "--scan-steps", "1", "--save-every", "100", "--log-every", "1",
            "--precision", "fp32", "--batch-per-device", str(batch),
            "--out", str(out)]


def _ckpt(path):
    params, _ = load_params(str(path), "lssvc")
    return {k: v.numpy() for k, v in params.items()}


def test_cli_world_of_one_is_the_plain_run(tmp_path):
    """Two steps drawn in one chunk (`--scan-steps 2`, the JAX trainer's
    scan) under a world of 1 and in the plain CLI: the same checkpoint."""
    argv = ["--scan-steps", "2"]
    torch_dist.run(torch_dist.cli, 1, tmp_path,
                   _argv(tmp_path / "dp" / "lssvc", 1) + argv)
    torch_dist.run(torch_dist.plain_cli, 1, tmp_path,
                   _argv(tmp_path / "plain" / "lssvc", 1) + argv,
                   group=False, threads_of=1)
    for name in ("lssvc_step2.npz", "lssvc_step2.state.npz"):
        dp = np.load(tmp_path / "dp" / name)
        plain = np.load(tmp_path / "plain" / name)
        assert sorted(dp.files) == sorted(plain.files)
        for k in plain.files:
            if k.startswith("__meta") or plain[k].dtype.kind in "OUS":
                continue
            assert np.array_equal(dp[k], plain[k]), (name, k)


def test_cli_world_of_two_matches_one_process_batch_two(tmp_path):
    """Batch 1 a rank on 2 ranks against batch 2 in one process: one Adam
    step moves each parameter by about lr * sign(gradient), so the
    checkpoints agree to rounding except where a cancelling sum's sign
    flips (a move of 2 lr)."""
    torch_dist.run(torch_dist.cli, 2, tmp_path,
                   _argv(tmp_path / "dp" / "lssvc", 1, steps=1))
    torch_dist.run(torch_dist.plain_cli, 1, tmp_path,
                   _argv(tmp_path / "plain" / "lssvc", 2, steps=1),
                   group=False, threads_of=2)
    assert not (tmp_path / "dp" / "lssvc_step1.npz.rank1").exists()
    dp, plain = (_ckpt(tmp_path / "dp" / "lssvc_step1.npz"),
                 _ckpt(tmp_path / "plain" / "lssvc_step1.npz"))
    diffs = np.concatenate([np.abs(dp[k] - plain[k]).ravel()
                            for k in plain])
    print(f"world 2 against batch 2: max |diff| {diffs.max():.3e}, "
          f"{np.mean(diffs > 1e-6):.2e} of the parameters past 1e-6")
    assert diffs.max() <= 2e-4 + 1e-6
    assert np.mean(diffs > 1e-6) < 1e-3


def test_dryrun_entry_runs_a_p_frame():
    fn, args = dryrun.entry("cpu")
    recon_el, recon_bl, bits = fn(*args)
    assert recon_el.shape == (1, 128, 128, 3)
    assert recon_bl.shape == (1, 64, 64, 3)
    assert bool(torch.isfinite(bits)) and float(bits) > 0


def test_dryrun_on_two_cpu_ranks(capfd):
    dryrun.main(["--n", "2", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "dryrun_multichip: 2 ranks passed" in out
    assert "spatial x1.5 exactness ok" in out
    assert out.count("grouped-warp halo fast path ok") == 2


def test_dryrun_never_moves_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--n", "2"])
