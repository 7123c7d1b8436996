"""The trainer's checkpoints (the JAX package's `checkpoint.py`): flat
parameter dicts in one `.npz`, keyed by the reference's names.

The weights are written in the JAX package's layouts
(`convert.params_to_jax`, the exact inverse of `params_from_jax`), so a
checkpoint crosses packages both ways: the JAX package's `load_params` and
`test.py` read one that the port trained, and the port's loaders
(`parallel/scheduler.py`, the trainer's `--resume`) read one that either
package wrote.  A training state (`<out>_step<n>.state.npz`) adds the
port's own optimizer state under `__opt__` keys (`__opt__count`,
`__opt__mu:<key>`, `__opt__nu:<key>`), which both packages' weight loaders
skip, and `__meta__step`, `__meta__n_opt` and `__meta__out_tag`.  A state
that the JAX package wrote holds its optimizer as `__opt__<i>`: the port
reads its parameters only (a cross-package resume is a params-only
handoff), as the JAX package reads the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import params_from_jax, params_to_jax


def _savez(path: str, arrays: dict):
    with open(path, "wb") as f:  # np.savez would append ".npz" to the name
        np.savez(f, **arrays)


def save_params(path: str, params: dict, model: str,
                metadata: dict | None = None):
    """`params` (torch layouts) of `model` (a model name of
    `convert.TRANSPOSED_KEYS`) into `path` in the JAX layouts, with
    `__meta__<key>` entries."""
    arrays = params_to_jax(params, model)
    for mk, mv in (metadata or {}).items():
        arrays[f"__meta__{mk}"] = np.asarray(mv)
    _savez(path, arrays)


def _split(data) -> tuple[dict, dict, dict]:
    params, opt, meta = {}, {}, {}
    for k in data.files:
        if k.startswith("__meta__"):
            meta[k[len("__meta__"):]] = data[k]
        elif k.startswith("__opt__"):
            opt[k[len("__opt__"):]] = data[k]
        else:
            params[k] = data[k]
    return params, opt, meta


def load_params(path: str, model: str, device="cpu"):
    """(params in torch layouts on `device`, metadata); a state file's
    optimizer entries are skipped."""
    with np.load(path, allow_pickle=False) as data:
        params, _, meta = _split(data)
    return ({k: v.to(device) for k, v in
             params_from_jax(params, model).items()}, meta)


def save_train_state(path: str, params: dict, model: str, opt_state: dict,
                     step: int, out_tag: str | None = None):
    """Parameters (JAX layouts), the optimizer state of
    `parallel.train.Adam` and the step.  `out_tag` names the run that wrote
    it (the trainer's `--out`): a resume from the same tag restores the
    optimizer and the step, another tag is a stage handoff (params only)."""
    arrays = params_to_jax(params, model)
    opt = {"__opt__count": np.asarray(opt_state["count"], np.int64)}
    for part in ("mu", "nu"):
        for k, v in opt_state[part].items():
            opt[f"__opt__{part}:{k}"] = v.detach().cpu().numpy()
    arrays.update(opt)
    arrays["__meta__step"] = np.asarray(step)
    arrays["__meta__n_opt"] = np.asarray(len(opt))
    if out_tag is not None:
        arrays["__meta__out_tag"] = np.asarray(out_tag)
    _savez(path, arrays)


def read_ckpt_meta(path: str) -> dict:
    """Only the `__meta__*` entries (np.load reads an entry when asked)."""
    with np.load(path, allow_pickle=False) as data:
        return {k[len("__meta__"):]: data[k] for k in data.files
                if k.startswith("__meta__")}


def load_train_state(path: str, model: str, device="cpu"):
    """(params, opt_state, step).  opt_state is None when the file holds no
    optimizer state of the port (a weights file, or a state the JAX package
    wrote)."""
    with np.load(path, allow_pickle=False) as data:
        params, opt, meta = _split(data)
    params = {k: v.to(device) for k, v in
              params_from_jax(params, model).items()}
    step = int(meta.get("step", 0))
    if "count" not in opt:
        return params, None, step
    state = {"count": int(opt["count"]), "mu": {}, "nu": {}}
    for k, v in opt.items():
        part, _, key = k.partition(":")
        if part in ("mu", "nu"):
            state[part][key] = torch.from_numpy(v.copy()).to(device)
    return params, state, step
