"""The last four Pallas warp kernels held against the port's warps, on the CPU.

Rows 5-8 of the kernel table (PERF.md) compute the warp that the port's
`flow_warp` / `grouped_warp` compute for every flow magnitude:

  _warp_kernel_cblock_roll, _warp_kernel_cblock_wide (via
      _flow_warp_pallas_cblock under LSSVC_WARP_ROLL / LSSVC_WARP_WIDE)
  _warp_kernel_smallflow (via _flow_warp_pallas_small, f32 output)
  _grouped_warp_kernel_smallflow (via _grouped_warp_pallas_small, f32)

Each runs in interpret mode here at |flow| <= 2 (its tier's bound) against
the port's wrapper, which takes the plain version on CPU tensors; atol 2e-6,
as tests/test_warp_pallas.py holds them.  Also: the tap-sum XLA
formulations against their port twins, and the port's tier bench covering
every variant of the JAX one.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssvc_tpu.ops.warp_pallas as jwp
from lssvc_tpu.ops import warp as jwarp
from lssvc_tpu_torch.ops import warp as twarp
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.tools import warp_tier_bench

from torch_threads import share_cores

share_cores()

ATOL = 2e-6
D_V, D_H = 3, 63


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _uniform(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    assert ref.dtype == np.float32 and port.dtype == torch.float32
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=0)


def test_flow_warp_matches_pallas_smallflow():
    x = _rand((1, 13, 140, 5), 51)
    flow = _uniform((1, 13, 140, 2), 52, -2, 2)
    flow[0, :2, :4] = 2.0  # samples clamped at the border
    ref = jwp._flow_warp_pallas_small(jnp.asarray(x), jnp.asarray(flow[..., 0]),
                                      jnp.asarray(flow[..., 1]), 2, D_V, D_H)
    _close(wk.flow_warp(torch.from_numpy(x).float(), torch.from_numpy(flow)),
           ref)


def test_grouped_warp_matches_pallas_smallflow():
    g, go = 4, 8
    x = _rand((1, 11, 135, 8), 53)
    fx, fy = (_uniform((1, 11, 135, go), s, -2, 2) for s in (54, 55))
    m = _rand((1, 11, 135, go), 56) ** 2
    ref = jwp._grouped_warp_pallas_small(
        *(jnp.asarray(a) for a in (x, fx, fy, m)), g, 2, D_V, D_H)
    out = wk.grouped_warp(*(torch.from_numpy(a) for a in (x, fx, fy, m)), g)
    _close(out, ref)


@pytest.mark.parametrize("flag,shape", [("_USE_ROLL", (1, 17, 131, 8)),
                                        ("_USE_WIDE", (1, 15, 133, 8))])
def test_flow_warp_matches_pallas_cblock_variant(monkeypatch, flag, shape):
    """The roll and wide cblock kernels, selected by the module flag at trace
    time: fresh shapes and cleared caches, so no earlier trace hides it."""
    monkeypatch.setattr(jwp, flag, True)
    x = _rand(shape, 57)
    flow = _uniform(shape[:3] + (2,), 58, -2, 2)
    jax.clear_caches()
    try:
        ref = jwp._flow_warp_pallas_cblock(
            jnp.asarray(x), jnp.asarray(flow[..., 0]),
            jnp.asarray(flow[..., 1]), 2, D_V, D_H)
        ref = np.asarray(ref)
    finally:
        jax.clear_caches()
    _close(wk.flow_warp(torch.from_numpy(x), torch.from_numpy(flow)), ref)


def test_flow_warp_shift_sum_matches_jax():
    x = _rand((2, 9, 21, 3), 59)
    flow = _uniform((2, 9, 21, 2), 60, -2, 2)
    flow[1, -2:, -3:] = 2.0
    ref = jwarp.flow_warp_shift_sum(jnp.asarray(x), jnp.asarray(flow), 2)
    _close(twarp.flow_warp_shift_sum(torch.from_numpy(x),
                                     torch.from_numpy(flow), 2), ref)


def test_grouped_warp_shift_sum_matches_jax():
    g, go = 4, 8
    x = _rand((1, 9, 21, 8), 61)
    fx, fy = (_uniform((1, 9, 21, go), s, -2, 2) for s in (62, 63))
    m = _uniform((1, 9, 21, go), 64, 0, 1)
    ref = jwarp.grouped_warp_shift_sum(
        *(jnp.asarray(a) for a in (x, fx, fy, m)), g, 2)
    out = twarp.grouped_warp_shift_sum(
        *(torch.from_numpy(a) for a in (x, fx, fy, m)), g, 2)
    _close(out, ref)


def test_tier_bench_maps_every_jax_variant():
    src = (Path(__file__).resolve().parents[1] / "tools"
           / "warp_tier_bench.py").read_text()
    jax_names = set(re.findall(r'name == "(\w+)"', src))
    assert len(jax_names) == 11
    assert set(warp_tier_bench.VARIANTS) == jax_names


def test_tier_bench_variants_equal_plain_versions_on_cpu():
    """Every variant through the port at a small size, against the plain
    gather version; CPU tensors launch no kernel."""
    inp = warp_tier_bench.make_inputs("cpu", h=10, w=14)
    n = (wk.flow_warp.launches, wk.grouped_warp.launches)
    for name in warp_tier_bench.VARIANTS:
        out = warp_tier_bench.call(name, inp)
        ref = warp_tier_bench.plain(name, inp)
        assert out.dtype == ref.dtype == torch.float32
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    assert (wk.flow_warp.launches, wk.grouped_warp.launches) == n
