"""Parameter scopes and the weight bridge from the JAX layouts.

Parameters are a flat dict keyed by the torch state_dict names of the
reference networks (e.g. "mv_encoder.0.weight"), held in torch layouts:

  * Conv2d weight           (O, I/groups, kH, kW)
  * ConvTranspose2d weight  (I, O, kH, kW), not flipped
  * Bitparm h / b / a       (1, C, 1, 1)
  * everything else (biases, GDN beta/gamma) as-is.

`params_from_jax` takes the JAX package's parameter dict as numpy arrays
(HWIO conv kernels, spatially flipped conv-equivalent transposed-conv
kernels, (1, 1, 1, C) Bitparm tensors) and returns these layouts.
`params_to_jax` is its exact inverse (the checkpoints the trainer writes
are in the JAX layouts).  `chain_specs_from_jax` does the same for a
conv-chain spec list (`ops/conv_chain.py`).
"""

from __future__ import annotations

import numpy as np
import torch

# ConvTranspose2d weights of the base-layer DMC (the reference's
# `dmc_net.py` hyper decoders and MV decoder).  Their layout cannot be told
# from a regular conv's by shape alone, and some of the names recur in
# other models as regular convs (the LSSVC enhancement layer's
# `res_prior_decoder.0`), so each model names its own set.
DMC_TRANSPOSED_KEYS = frozenset(
    [f"mv_prior_decoder.{i}.weight" for i in (0, 2, 4)]
    + [f"mv_decoder.{i}.weight" for i in (0, 4, 6, 8)]
    + [f"res_prior_decoder.{i}.weight" for i in (0, 2, 4)]
)
# The two-layer LSSVC holds the DMC under `base_layer_model.`; its own
# enhancement-layer decoders are sub-pixel convs, not transposed convs.
LSSVC_TRANSPOSED_KEYS = frozenset(
    "base_layer_model." + k for k in DMC_TRANSPOSED_KEYS)
# The transposed-conv keys of each model.  The image models have none
# (IntraSS's `base_layer_model.` is an IntraNoAR; Cheng2020Anchor is
# IntraNoAR's keys plus `context_prediction` and `entropy_parameters.{0,2,4}`,
# all regular convs).
TRANSPOSED_KEYS = {"dmc": DMC_TRANSPOSED_KEYS, "lssvc": LSSVC_TRANSPOSED_KEYS,
                   "intra_noar": frozenset(), "intra_ss": frozenset(),
                   "cheng2020": frozenset()}


def params_from_jax(np_params: dict, model: str) -> dict[str, torch.Tensor]:
    """JAX-layout parameters (numpy arrays) of `model` (a key of
    TRANSPOSED_KEYS: "dmc", "lssvc", "intra_noar", "intra_ss",
    "cheng2020") -> torch-layout CPU tensors."""
    transposed = TRANSPOSED_KEYS[model]
    out = {}
    for key, val in np_params.items():
        a = np.asarray(val)
        if a.ndim == 4 and key in transposed:
            # conv-equivalent (kH, kW, I, O) -> (I, O, kH, kW), un-flipped
            a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif a.ndim == 4 and key.endswith(".weight"):
            # HWIO -> OIHW (grouped/depthwise (k, k, 1, C) -> (C, 1, k, k))
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 4:
            # per-channel Bitparm (1, 1, 1, C) -> (1, C, 1, 1)
            a = a.reshape(1, -1, 1, 1)
        out[key] = torch.from_numpy(a.copy())  # C-contiguous, writable
    return out


def params_to_jax(params: dict, model: str) -> dict[str, np.ndarray]:
    """The exact inverse of `params_from_jax`: torch-layout tensors of
    `model` -> JAX-layout numpy arrays (C-contiguous, f32 as held), which
    the JAX package's `checkpoint.load_params` reads."""
    transposed = TRANSPOSED_KEYS[model]
    out = {}
    for key, val in params.items():
        a = val.detach().cpu().numpy()
        if a.ndim == 4 and key in transposed:
            # (I, O, kH, kW) -> spatially flipped (kH, kW, I, O)
            a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4 and key.endswith(".weight"):
            # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 4:
            # per-channel Bitparm (1, C, 1, 1) -> (1, 1, 1, C)
            a = a.reshape(1, 1, 1, -1)
        out[key] = np.ascontiguousarray(a)
    return out


def chain_specs_from_jax(specs) -> list[dict]:
    """A JAX conv-chain spec list (numpy weights) -> the port's: HWIO conv
    weights become OIHW, a dw3 weight (3, 3, 1, C) becomes (C, 1, 3, 3),
    biases become f32 tensors (None stays None); other keys are kept."""
    out = []
    for s in specs:
        t = dict(s)
        if "w" in t:
            t["w"] = torch.from_numpy(
                np.asarray(t["w"], np.float32).transpose(3, 2, 0, 1).copy())
        if t.get("b") is not None:
            t["b"] = torch.from_numpy(np.asarray(t["b"], np.float32).copy())
        out.append(t)
    return out


class P:
    """Scoped view over the flat parameter dict: P(params, 'g_a.0.')('weight')."""

    __slots__ = ("d", "prefix")

    def __init__(self, d, prefix: str = ""):
        self.d = d
        self.prefix = prefix

    def __call__(self, name: str):
        return self.d[self.prefix + name]

    def sub(self, name: str) -> "P":
        return P(self.d, self.prefix + name + ".")

    def __contains__(self, name: str) -> bool:
        return self.prefix + name in self.d
