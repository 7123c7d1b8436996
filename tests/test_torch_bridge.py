"""The port's weight bridge, its isolation from JAX, and its device rule."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lssvc_tpu_torch.convert import (
    DMC_TRANSPOSED_KEYS,
    LSSVC_TRANSPOSED_KEYS,
    params_from_jax,
)
from lssvc_tpu_torch.models import DMC, LSSVC
from lssvc_tpu_torch.models.init import init_dmc

REPO = Path(__file__).resolve().parents[1]


def test_bridge_layouts():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    dw = rng.normal(size=(3, 3, 1, 9)).astype(np.float32)
    bp = rng.normal(size=(1, 1, 1, 4)).astype(np.float32)
    # a DMC dict: `res_prior_decoder.0` is a transposed conv
    d = params_from_jax({"res_prior_decoder.0.weight": w, "dw.weight": dw,
                         "be.f1.h": bp}, "dmc")
    np.testing.assert_array_equal(d["res_prior_decoder.0.weight"].numpy(),
                                  w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(d["dw.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(d["be.f1.h"].numpy(), bp.reshape(1, 4, 1, 1))
    # an LSSVC dict: the EL's `res_prior_decoder.0` is a plain conv, the
    # BL's is transposed
    both = {"res_prior_decoder.0.weight": w,
            "base_layer_model.res_prior_decoder.0.weight": w}
    d = params_from_jax(both, "lssvc")
    np.testing.assert_array_equal(d["res_prior_decoder.0.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    assert tuple(d["base_layer_model.res_prior_decoder.0.weight"].shape) == \
        (5, 7, 3, 3)
    assert LSSVC_TRANSPOSED_KEYS == {"base_layer_model." + k
                                     for k in DMC_TRANSPOSED_KEYS}
    # the I-frame models have no transposed conv, whatever the names
    for model in ("intra_noar", "intra_ss"):
        d = params_from_jax(both, model)
        for key in both:
            np.testing.assert_array_equal(d[key].numpy(),
                                          w.transpose(3, 2, 0, 1))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of lssvc_tpu_torch, and chip_smoke.py, imported in a
    fresh interpreter leave no `jax` and no `lssvc_tpu` module loaded."""
    code = r"""
import importlib, pkgutil, sys
import lssvc_tpu_torch
for m in pkgutil.walk_packages(lssvc_tpu_torch.__path__, "lssvc_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "lssvc_tpu") or n.startswith(("jax.", "lssvc_tpu.")))
assert not bad, bad
assert "lssvc_tpu_torch.models.lssvc" in sys.modules
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_dmc(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DMC(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LSSVC({}, device="cuda")
    assert DMC(params, device="cpu").device == torch.device("cpu")


def test_own_dmc_init_loads_strict():
    params = init_dmc(torch.Generator().manual_seed(1))
    model = DMC(params, device="cpu")
    model.load_state_dict(init_dmc(torch.Generator().manual_seed(2)),
                          strict=True)
    assert set(model.state_dict()) == set(params)


def test_kernel_library_is_keyed_by_source(tmp_path, monkeypatch):
    """The built library's name carries a hash of its source, so an edited
    kernel rebuilds; without nvcc the build raises instead of falling back."""
    from lssvc_tpu_torch import build

    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    src.write_text("// two\n")
    assert build.library_path("k") != first
    assert build.library_path("k").parent == tmp_path / "_build"
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("k")
