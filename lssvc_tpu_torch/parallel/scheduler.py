"""Task runner for evaluation sweeps (the JAX package's
`parallel/scheduler.py`).

Models are cached per checkpoint path, precision and int8 table (its
content, not its path), so a sweep over (dataset x ratio x sequence) loads
each network once in each precision, and two tables never share a model.
Under `write_stream` a model builds its CDF tables on load, and its bins
go to `<stream_path>/<sequence>/<model_idx>/<ratio>/{BL,EL}/`.

`run_tasks(tasks, worker_num)` runs the tasks on a pool of `worker_num`
threads, all on the one device.  A cached model carries per-task state
(its scale information, its rANS coders' buffers, its profiling sums), so
the tasks that share one take its lock in turn; tasks on different models
run at once: one task's host work (YUV reads, metrics, rANS) beside
another's device work.  The backend flags of a model's precision are
process-wide (`ops.nn.precision_scope`), so a pool refuses, before it
starts, tasks whose precisions need different flags; the CLI's tasks
share one precision.
"""

from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..convert import params_from_jax
from ..harness.runner import ARTIFACTS, run_test
from ..models import IntraSS
from ..models.init import init_intra_ss, init_lssvc
from ..models.lssvc_stream import LSSVCExtend
from ..ops.nn import backend_flags, packed_ctx_from_env, serving_mode
from ..utils.platform import resolve_device

BL_CHANNEL_KEY = "base_layer_model.g_s.0.conv1.weight"


def _state_dict(path: str, kind: str) -> dict:
    """A reference checkpoint (.pth, already in the port's layout) or a JAX
    package checkpoint (.npz, bridged as `kind`, a model name of
    `convert.params_from_jax`) as name -> CPU tensor; `module.`
    prefixes stripped, the Gaussian conditionals' scale tables dropped (the
    JAX loaders drop them too: `intra_noar.py:143`, `intra_ss.py:188`)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files
                      if not k.startswith(("__meta__", "__opt__"))}
        sd = params_from_jax(arrays, kind)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.endswith("gaussian_conditional.scale_table")}


@functools.lru_cache(maxsize=None)
def _shapes(init, *args) -> dict:
    """Key -> shape of the port's own `init(generator, *args)`, drawn once
    a process."""
    params = init(torch.Generator().manual_seed(0), *args)
    return {k: tuple(v.shape) for k, v in params.items()}


def _checked(sd: dict, shapes: dict, path: str) -> dict:
    """`sd` held to the model's key `shapes`: a missing key or another
    shape is an error; a key the model never reads (such as the reference's
    `ms_ssim_loss.*`) is dropped with a printed note."""
    missing = sorted(set(shapes) - set(sd))
    if missing:
        raise KeyError(f"{path}: {len(missing)} missing keys, e.g. "
                       f"{missing[:5]}")
    unused = sorted(set(sd) - set(shapes))
    if unused:
        print(f"note: {path}: dropped {len(unused)} keys the model does not "
              f"read, e.g. {unused[:5]}")
    wrong = [k for k, s in shapes.items() if tuple(sd[k].shape) != s]
    if wrong:
        raise ValueError(f"{path}: shapes differ from the model's at {wrong[:5]}")
    return {k: sd[k].float() for k in shapes}


def load_intra(path: str, device, precision="fp32",
               int8_table=None) -> IntraSS:
    """IntraSS in `precision`; "int8" also packs its shared components
    (packed width 2) and takes the table (`ops.nn.serving_mode`)."""
    sd = _state_dict(path, "intra_ss")
    shapes = _shapes(init_intra_ss, int(sd[BL_CHANNEL_KEY].shape[0]))
    return IntraSS(_checked(sd, shapes, path), device=device,
                   **serving_mode(precision, int8_table))


def load_video(path: str, device, od_offset_cap, precision="fp32",
               int8_table=None) -> LSSVCExtend:
    """LSSVCExtend with OffsetDiversity's cap `od_offset_cap` (px, None for
    no cap), in `precision`; "int8" runs at packed width 2 with the table
    and reads `LSSVC_PACKED_CTX`, as the JAX package's CLI does."""
    params = _checked(_state_dict(path, "lssvc"), _shapes(init_lssvc), path)
    mode = serving_mode(precision, int8_table)
    if precision == "int8":
        mode["packed_ctx"] = packed_ctx_from_env()
    return LSSVCExtend(params, device=device, od_offset_cap=od_offset_cap,
                       **mode)


def _table_key(table):
    return None if table is None else tuple(sorted(table.items()))


class Runner:
    """Runs tasks on one device, loading each checkpoint once a precision
    and int8 table (a task's "precision" and "int8_table", else
    `precision` and `int8_table`); the video models take OffsetDiversity's
    cap `od_offset_cap`.  `models` maps a cache key to (intra, video);
    `locks` maps it to the lock its tasks take in turn."""

    def __init__(self, device, od_offset_cap, precision="fp32",
                 int8_table=None):
        self.device = device
        self.od_offset_cap = od_offset_cap
        self.precision = precision
        self.int8_table = int8_table
        self.models = {}
        self.locks = {}
        self._cache_lock = threading.Lock()

    def _key(self, task):
        return (task["i_frame_model_path"],
                None if task.get("force_intra") else task["video_model_path"],
                task.get("precision", self.precision),
                _table_key(task.get("int8_table", self.int8_table)))

    def _models(self, task):
        key = self._key(task)
        with self._cache_lock:
            if key not in self.models:
                precision = task.get("precision", self.precision)
                table = task.get("int8_table", self.int8_table)
                intra = load_intra(task["i_frame_model_path"], self.device,
                                   precision, table)
                video = (None if task.get("force_intra")
                         else load_video(task["video_model_path"],
                                         self.device, self.od_offset_cap,
                                         precision, table))
                if task.get("write_stream"):
                    for model in (intra, video):
                        if model is not None:
                            model.update(force=True)
                self.models[key] = (intra, video)
                self.locks[key] = threading.Lock()
            return self.models[key]

    def run_one(self, task: dict):
        i_frame_net, video_net = self._models(task)
        sub_dir = task["video_path"]
        model_dir = str(task.get("model_idx", 0))
        task = dict(task, gop_size=task["gop"], yuv_path_el=os.path.join(
            task["dataset_path"], sub_dir, "x1.yuv"),
            bin_folder=os.path.join(task.get("stream_path", "out_bin"),
                                    sub_dir, model_dir))
        for a in ARTIFACTS:  # `lssvc_tpu/parallel/scheduler.py:56-61`
            task[f"{a}_folder"] = os.path.join(
                task.get(f"{a}_path", f"{a}_folder"), sub_dir, model_dir)
        # per-stage decode seconds of both layers, streams only
        profiling = (task.get("decoding_profiling") and video_net is not None
                     and task.get("write_stream"))
        with self.locks[self._key(task)]:
            if profiling:
                for model in (video_net.base_layer_model, video_net):
                    model.profile_decoding = True
                    model.reset_decoding_profiling()
            res_bl, res_el, res_fl = run_test(video_net, i_frame_net, task)
            if profiling:
                res_bl["decoding_profiling"] = video_net.base_layer_model \
                    .get_average_decoding_profiling()
                res_el["decoding_profiling"] = \
                    video_net.get_average_decoding_profiling()
        name = (f"{os.path.basename(task.get('video_model_path', 'intra'))}"
                f"_{sub_dir}")
        for res in (res_bl, res_el, res_fl):
            res["name"] = name
            res["ds_name"] = task["ds_name"]
            res["video_path"] = task["video_path"]
            res["ratio"] = task["ratio"]
            res["model_idx"] = task.get("model_idx", 0)
        return res_bl, res_el, res_fl

    def run_tasks(self, tasks, worker_num: int = 1):
        """Each task's (log_BL, log_EL, log_FL), in the tasks' order; with
        `worker_num` > 1 on that many threads, tasks whose precisions need
        one set of backend flags only (module docstring)."""
        if worker_num <= 1:
            results = []
            for i, task in enumerate(tasks):
                print(f"[{i + 1}/{len(tasks)}] {task['ds_name']}/"
                      f"{task['video_path']} {task['ratio']}")
                results.append(self.run_one(task))
            return results
        flags = {backend_flags(t.get("precision", self.precision))
                 for t in tasks}
        if len(flags) > 1:
            raise ValueError(
                f"{worker_num} workers: the tasks' precisions need different "
                f"backend flags {sorted(flags)}, which are process-wide; run "
                "them with one worker, or one precision a run")
        with ThreadPoolExecutor(max_workers=worker_num) as pool:
            futures = [pool.submit(self.run_one, t) for t in tasks]
            results = []
            for i, fut in enumerate(futures):
                results.append(fut.result())
                print(f"[{i + 1}/{len(tasks)}] done")
        return results


def run_tasks(tasks, worker_num: int = 1, device="cuda",
              od_offset_cap=None, precision="fp32", int8_table=None):
    """The JAX package's module-level `run_tasks`: every task on a fresh
    `Runner` of `device` (see `Runner.run_tasks`)."""
    return Runner(resolve_device(device), od_offset_cap, precision,
                  int8_table).run_tasks(tasks, worker_num)
