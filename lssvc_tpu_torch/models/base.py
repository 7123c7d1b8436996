"""Model base: an nn.Module holding a flat parameter dict under its
reference state_dict names, on an explicit device.

Layer bodies are plain functions over a scoped view `P` of the flat dict,
as in the JAX package; the module tree exists so that `state_dict()` keys
and shapes equal that dict and `load_state_dict(strict=True)` takes it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import set_fp32_parity
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


class Model(nn.Module):
    def __init__(self, params: dict, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        for key, value in params.items():
            _register(self, key, value)
        self.to(self.device)
        # fp32 is the parity mode, and the only mode of this model
        set_fp32_parity()

    def flat_params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())
