"""Model base: an nn.Module holding a flat parameter dict under its
reference state_dict names, on an explicit device.

Layer bodies are plain functions over a scoped view `P` of the flat dict,
as in the JAX package; the module tree exists so that `state_dict()` keys
and shapes equal that dict and `load_state_dict(strict=True)` takes it.

A model holds its numerics (`ops.nn.Mode`: precision, packed width, 1x1
convs as matmuls) and runs every public entry point inside
`precision_scope` of that mode (the `scoped` decorator), so two models in
one process may run in different modes and nothing is left set after a
call.  The packed kernels of the width-packed domain are built once per
model and mode and cached on the model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch import nn

from ..ops.int8 import Int8Sites
from ..ops.nn import Mode, precision_scope
from ..utils.platform import resolve_device


def _register(root: nn.Module, key: str, value: torch.Tensor):
    *path, leaf = key.split(".")
    mod = root
    for part in path:
        child = mod._modules.get(part)
        if child is None:
            child = nn.Module()
            mod.add_module(part, child)
        mod = child
    mod.register_parameter(leaf, nn.Parameter(value, requires_grad=False))


def scoped(method):
    """A public entry point of a Model: no autograd, run in the model's
    mode."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with torch.no_grad(), self.scope():
            return method(self, *args, **kwargs)

    return run


class Model(nn.Module):
    """`precision`: "fp32" (the parity mode), "high", "bf16",
    "bf16_f32out" or "int8"; `packed_width` 1 or 2; `conv1x1_einsum` runs
    1x1 convs as matmuls; `packed_ctx` the EL's fused packed pair warp
    (LSSVC only); `int8_table` the calibration table (key -> activation
    scale) that "int8" serves from.  See `ops.nn.Mode`."""

    def __init__(self, params: dict, device="cuda", precision="fp32",
                 packed_width=1, conv1x1_einsum=False, packed_ctx=False,
                 int8_table=None):
        super().__init__()
        self.device = resolve_device(device)
        for key, value in params.items():
            _register(self, key, value)
        self.to(self.device)
        self.mode = Mode(precision, packed_width, conv1x1_einsum, packed_ctx,
                         cache={}, int8=Int8Sites(dict(int8_table or {})))

    @property
    def precision(self) -> str:
        return self.mode.precision

    def scope(self):
        """The model's mode as a `precision_scope`."""
        return precision_scope(self.mode)

    def share_int8(self, other: "Model"):
        """Take `other`'s int8 state (table, served sites, recorder): a
        base layer shares its two-layer model's."""
        self.mode = dataclasses.replace(self.mode, int8=other.mode.int8)

    @contextlib.contextmanager
    def recording(self):
        """Collect each conv site's input absmax while the block runs (the
        JAX package's `int8.recording`): yields the dict, key -> 0-d f32
        tensor, that the sites fill."""
        sites = self.mode.int8
        if sites.stats is not None:
            raise RuntimeError("nested calibration recording")
        sites.stats = {}
        try:
            yield sites.stats
        finally:
            sites.stats = None

    def flat_params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())


# The motion-prediction submodules of the reference's selective-freeze
# stages (`dmc_net.py:283-290`; the JAX package's `models/base.py:87-96`):
# `python -m lssvc_tpu_torch.train --freeze` partitions by this list.
INTER_PREDICTION_MODULES = ("mv_encoder", "mv_decoder", "mv_prior_encoder",
                            "mv_prior_decoder", "bit_estimator_z_mv",
                            "optic_flow")


def label_params(params, inter_module_names=INTER_PREDICTION_MODULES):
    """'prediction' / 'other' label per parameter name, by substring."""
    return {k: ("prediction"
                if any(m in k for m in inter_module_names) else "other")
            for k in params}
