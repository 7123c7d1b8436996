"""The CLI's worker pool (`lssvc_tpu_torch/parallel/scheduler.py`
`Runner.run_tasks(tasks, worker_num)`) and the process-wide backend flags
under concurrent model scopes (`ops/nn.py` `precision_scope`).

Two workers over tasks on two models give one worker's results (NaN equal
to NaN, wall-clock seconds aside); tasks that share a model never overlap,
tasks on two models do; and a thread's fp32 scope keeps TF32 off after
another thread's scope has closed.  The CLI case codes a synthetic
128x128 sequence, 2 frames (I P), x2, fp32, estimated bits, with two
copies of one `.pth` checkpoint of the JAX package's `init_lssvc(0)`
(and `init_intra_ss(192)`) bridged by `params_from_jax`.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.ops.nn import Mode, precision_scope
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.tools.synthetic import write_dataset

from torch_threads import share_cores

share_cores()


def _same(a, b):
    """Equal results, NaN equal to NaN; wall-clock seconds skipped."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            if not k.endswith("_time"):
                _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b, (a, b)


def test_two_workers_give_one_workers_results(tmp_path):
    cfg = write_dataset(tmp_path / "ds", 128, 128, frames=2, gop=2, seed=9)
    intra = tmp_path / "intra.pth"
    torch.save(params_from_jax({k: np.asarray(v) for k, v in
                                j_init_intra_ss(192).items()}, "intra_ss"),
               intra)
    video = params_from_jax({k: np.asarray(v)
                             for k, v in j_init_lssvc(0).items()}, "lssvc")
    copies = [tmp_path / "a" / "video.pth", tmp_path / "b" / "video.pth"]
    for path in copies:
        path.parent.mkdir()
        torch.save(video, path)
    runs = {}
    for workers in (1, 2):
        runs[workers] = cli.main([
            "--test_config", str(cfg), "--i_frame_model_path", str(intra),
            str(intra), "--model_path", *map(str, copies), "--output_path",
            str(tmp_path / f"out{workers}"), "--ratios", "x2", "--device",
            "cpu", "--worker", str(workers)])
    assert len(runs[1]) == 2
    _same(runs[2], runs[1])
    assert runs[1][0][1]["model_idx"] == 0 and runs[1][1][1]["model_idx"] == 1


def test_tasks_on_one_model_never_overlap(monkeypatch):
    """Three tasks on model A and one on model B on three workers: A's
    tasks enter and leave one at a time; B's task runs inside one of A's
    (each waits, inside, for the other to be inside)."""
    monkeypatch.setattr(scheduler, "load_intra", lambda path, *a: path)
    monkeypatch.setattr(scheduler, "load_video", lambda path, *a: path)
    order, lock = [], threading.Lock()
    inside = {"a": threading.Event(), "b": threading.Event()}

    def fake_run_test(video_net, i_frame_net, task):
        tag = video_net[0]
        with lock:
            order.append(("enter", tag))
        inside[tag].set()
        if not inside["b" if tag == "a" else "a"].wait(timeout=30):
            raise AssertionError("models a and b never ran at once")
        time.sleep(0.05)
        with lock:
            order.append(("leave", tag))
        return {}, {}, {}

    monkeypatch.setattr(scheduler, "run_test", fake_run_test)
    tasks = [{"i_frame_model_path": "i", "video_model_path": v, "gop": 2,
              "dataset_path": "d", "video_path": "s", "ds_name": "ds",
              "ratio": "x2"} for v in ("a", "a", "b", "a")]
    runner = scheduler.Runner("cpu", None)
    assert len(runner.run_tasks(tasks, 3)) == 4
    a_events = [e for e, tag in order if tag == "a"]
    assert a_events == ["enter", "leave"] * 3
    assert len(runner.models) == 2 and set(runner.locks) == set(runner.models)


def test_precision_scope_keeps_the_flags_across_threads():
    """Thread A and thread B each hold an fp32 scope; A leaves first.
    Inside B, after A has left, TF32 still reads off; once both have
    left, the flags before the first scope come back.  A scope that needs
    other flags than another thread holds raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
             cudnn.deterministic)
    cudnn.allow_tf32 = matmul.allow_tf32 = True  # PyTorch's cuDNN default
    barrier = threading.Barrier(2)
    seen, errors = {}, []

    def worker(name, leave_first):
        try:
            with precision_scope(Mode("fp32")):
                barrier.wait()  # both inside
                if leave_first:
                    return
                barrier.wait()  # the other has left
                seen[name] = (cudnn.allow_tf32, matmul.allow_tf32,
                              cudnn.benchmark, cudnn.deterministic)
                # B holds the flags alone now: a nested scope of its own
                # may change them, and its enclosing scope's come back
                with precision_scope(Mode("high")):
                    seen["nested"] = (cudnn.allow_tf32, matmul.allow_tf32)
                seen["after"] = (cudnn.allow_tf32, matmul.allow_tf32)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            if leave_first:
                barrier.wait()

    try:
        threads = [threading.Thread(target=worker, args=("a", True)),
                   threading.Thread(target=worker, args=("b", False))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert seen["b"] == (False, False, False, True)
        assert seen["nested"] == (True, True)
        assert seen["after"] == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)

        held, release = threading.Event(), threading.Event()

        def holder():
            with precision_scope(Mode("fp32")):
                held.set()
                release.wait(timeout=60)

        t = threading.Thread(target=holder)
        t.start()
        held.wait(timeout=60)
        try:
            with pytest.raises(RuntimeError, match="another thread's scope"):
                with precision_scope(Mode("high")):
                    pass
            with precision_scope(Mode("bf16")):  # the same flags: joins
                assert not cudnn.allow_tf32
        finally:
            release.set()
            t.join(timeout=60)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
         cudnn.deterministic) = saved


@pytest.mark.parametrize("precisions, refused", [
    (("fp32", "high"), True),  # TF32 off and on
    (("fp32", "bf16", "int8"), False),  # one set of flags
])
def test_pool_refuses_precisions_that_need_other_flags(monkeypatch,
                                                       precisions, refused):
    """The backend flags are process-wide, so two workers refuse, before
    any task runs, tasks whose precisions need different flags; one worker
    runs them, one after another."""
    monkeypatch.setattr(scheduler, "load_intra", lambda path, *a: path)
    monkeypatch.setattr(scheduler, "load_video", lambda path, *a: path)
    ran = []
    monkeypatch.setattr(scheduler, "run_test",
                        lambda v, i, task: ran.append(task["precision"])
                        or ({}, {}, {}))
    tasks = [{"i_frame_model_path": "i", "video_model_path": "v", "gop": 2,
              "dataset_path": "d", "video_path": "s", "ds_name": "ds",
              "ratio": "x2", "precision": p} for p in precisions]
    if refused:
        with pytest.raises(ValueError, match="different backend flags"):
            scheduler.Runner("cpu", None).run_tasks(tasks, 2)
        assert ran == []
    else:
        assert len(scheduler.Runner("cpu", None).run_tasks(tasks, 2)) \
            == len(tasks)
        assert sorted(ran) == sorted(precisions)
    ran.clear()
    assert len(scheduler.Runner("cpu", None).run_tasks(tasks, 1)) \
        == len(tasks)
    assert ran == list(precisions)
