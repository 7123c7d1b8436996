"""The port's warps against the JAX package's, on the CPU.

The plain PyTorch `flow_warp` and `grouped_warp_plain` (what the CUDA
kernels of lssvc_tpu_torch/csrc/warp.cu repeat operation for operation) are
held against the XLA warps of `lssvc_tpu.ops.warp`, the CPU path of
`grouped_warp_auto`, and the Pallas kernels themselves in interpret mode, as
tests/test_warp_pallas.py calls them.  fp32 atol 2e-6, as those tests use;
bf16 within one bf16 ulp of the f32 result.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lssvc_tpu.ops import warp as jwarp
from lssvc_tpu.ops import warp_pallas as jwp
from lssvc_tpu_torch.ops import warp as twarp
from lssvc_tpu_torch.ops import warp_kernels as wk

from torch_threads import share_cores

share_cores()

ATOL = 2e-6
# kernel window parameters as tests/test_warp_pallas.py uses them:
# (2*d_h+2) % 128 == 0 and (2*d_v+2) % 8 == 0
D_V, D_H = 3, 63


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _uniform(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(port, ref, atol=ATOL):
    ref = np.asarray(ref, dtype=np.float32)
    port = port.float().numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=atol, rtol=0)


def _flow_warp(x, flow):
    return wk.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))


def _grouped(x, fx, fy, m, g):
    return wk.grouped_warp(*(torch.from_numpy(a) for a in (x, fx, fy, m)), g)


@pytest.mark.parametrize("shape,lo,hi", [
    ((1, 16, 128, 8), -2, 2),       # aligned, tiny-tier flows
    ((1, 14, 150, 3), -20, 20),     # unaligned, RGB
    ((2, 14, 150, 5), -300, 300),   # batch 2, flows far past the borders
])
def test_flow_warp_matches_xla(shape, lo, hi):
    x = _rand(shape, 1)
    flow = _uniform(shape[:3] + (2,), 2, lo, hi)
    _close(_flow_warp(x, flow), jwarp.flow_warp(jnp.asarray(x),
                                                 jnp.asarray(flow)))


def test_flow_warp_border_clamp_and_nan():
    x = _rand((1, 14, 150, 2), 4)
    flow = np.full((1, 14, 150, 2), 2.0, np.float32)
    _close(_flow_warp(x, flow), jwarp.flow_warp(jnp.asarray(x),
                                                 jnp.asarray(flow)))
    # a NaN flow gives NaN at its pixel and reads nothing out of range
    flow[0, 3, 7, 0] = np.nan
    out = _flow_warp(x, flow).numpy()
    assert np.isnan(out[0, 3, 7]).all()
    assert np.isfinite(np.delete(out.reshape(-1, 2), 3 * 150 + 7, 0)).all()


def test_flow_warp_bf16_within_one_ulp():
    x = _rand((1, 14, 150, 8), 5)
    flow = _uniform((1, 14, 150, 2), 6, -3, 3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = wk.flow_warp(xb, torch.from_numpy(flow))
    assert out.dtype == torch.bfloat16
    # the JAX XLA warp promotes bf16 taps to f32
    ref = np.asarray(jwarp.flow_warp(jnp.asarray(xb.float().numpy(),
                                                 jnp.bfloat16),
                                     jnp.asarray(flow)), np.float32)
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert (np.abs(out.float().numpy() - ref) <= ulp).all()


def test_flow_warp_matches_pallas_cblock_tiny_tier():
    x = _rand((1, 14, 150, 8), 7)
    flow = _uniform((1, 14, 150, 2), 8, -2, 2)
    ref = jwp._flow_warp_pallas_cblock(jnp.asarray(x),
                                       jnp.asarray(flow[..., 0]),
                                       jnp.asarray(flow[..., 1]), 2, D_V, D_H)
    _close(_flow_warp(x, flow), ref)


def test_flow_warp_matches_pallas_windowed():
    # batch 2, unaligned: the windowed kernel's padding and true-border clamp
    x = _rand((2, 14, 150, 3), 9)
    flow = _uniform((2, 14, 150, 2), 10, -1, 1)
    flow[..., 0] *= D_H - 1
    flow[..., 1] *= D_V - 1
    ref = jwp._flow_warp_pallas(jnp.asarray(x), jnp.asarray(flow[..., 0]),
                                jnp.asarray(flow[..., 1]), D_V, D_H)
    _close(_flow_warp(x, flow), ref)


def _block_ref(x, fx, fy, m, g):
    """The JAX package's eager block-layout grouped path."""
    cg = x.shape[-1] // g
    off = fx.shape[-1] // g
    x = jnp.asarray(x)
    planes = [x[..., k::cg] for k in range(cg)]
    x_blk = jnp.concatenate([p for plane in planes for p in (plane,) * off],
                            axis=-1)
    return jwarp.flow_warp_grouped(x_blk, jnp.asarray(fx), jnp.asarray(fy)) \
        * jnp.concatenate([jnp.asarray(m)] * cg, axis=-1)


@pytest.mark.parametrize("shape,lo,hi", [
    ((1, 14, 150, 8), -2, 2),
    ((2, 12, 40, 8), -50, 50),
])
def test_grouped_warp_matches_auto_cpu_path(shape, lo, hi):
    g, go = 4, 8
    fshape = shape[:3] + (go,)
    x = _rand(shape, 11)
    fx, fy = _uniform(fshape, 12, lo, hi), _uniform(fshape, 13, lo, hi)
    m = _uniform(fshape, 14, 0, 1)
    ref = jwp.grouped_warp_auto(*(jnp.asarray(a) for a in (x, fx, fy, m)), g)
    _close(_grouped(x, fx, fy, m, g), ref)


def test_grouped_warp_offset_diversity_layout():
    """16 groups x 2 offsets over 48 channels, as OffsetDiversity runs it."""
    g, go = 16, 32
    x = _rand((1, 10, 12, 48), 15)
    fx, fy = (_uniform((1, 10, 12, go), s, -12, 12) for s in (16, 17))
    m = _uniform((1, 10, 12, go), 18, 0, 1)
    _close(_grouped(x, fx, fy, m, g), _block_ref(x, fx, fy, m, g))


@pytest.mark.parametrize("b,d_v", [(2, D_V), (12, 15)])
def test_grouped_warp_matches_pallas_cblock(b, d_v):
    """Tiny (b=2) and mid (b=12, d_v=15) tiers of the cblock kernel,
    unaligned shape."""
    g, go = 4, 8
    h, w = 14, 150
    x = _rand((1, h, w, 8), 20 + b)
    fx, fy = (_uniform((1, h, w, go), s + b, -b, b) for s in (21, 22))
    m = _rand((1, h, w, go), 23) ** 2
    ref = jwp._grouped_warp_pallas_cblock(
        *(jnp.asarray(a) for a in (x, fx, fy, m)), g, b, d_v, D_H)
    _close(_grouped(x, fx, fy, m, g), ref)


def test_grouped_warp_matches_pallas_windowed():
    g, go = 2, 4
    h, w = 14, 150
    x = _rand((1, h, w, 4), 24)
    fx = np.clip(_rand((1, h, w, go), 25, 1.5), -(D_H - 1), D_H - 1)
    fy = np.clip(_rand((1, h, w, go), 26, 1.5), -(D_V - 1), D_V - 1)
    m = np.abs(_rand((1, h, w, go), 27))
    ref = jwp._grouped_warp_pallas(*(jnp.asarray(a) for a in (x, fx, fy, m)),
                                   D_V, D_H, g)
    _close(_grouped(x, fx, fy, m, g), ref)


def test_grouped_warp_bf16_source():
    g, go = 4, 8
    x = torch.from_numpy(_rand((1, 9, 20, 8), 28)).to(torch.bfloat16)
    fx, fy = (_uniform((1, 9, 20, go), s, -3, 3) for s in (29, 30))
    m = _uniform((1, 9, 20, go), 31, 0, 1)
    out = wk.grouped_warp(x, torch.from_numpy(fx), torch.from_numpy(fy),
                          torch.from_numpy(m), g)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(_block_ref(x.float().numpy(), fx, fy, m, g))
    assert (np.abs(out.float().numpy() - ref)
            <= np.abs(ref) * 2.0 ** -7 + 1e-30).all()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers are the plain versions and count no launch."""
    x = _rand((1, 6, 10, 4), 32)
    flow = _uniform((1, 6, 10, 2), 33, -2, 2)
    fx, fy = (_uniform((1, 6, 10, 4), s, -2, 2) for s in (34, 35))
    m = _uniform((1, 6, 10, 4), 36, 0, 1)
    n_fw, n_gw = wk.flow_warp.launches, wk.grouped_warp.launches
    a, b = wk.flow_warp_pair(torch.from_numpy(x[..., :1]),
                             torch.from_numpy(x[..., 1:]),
                             torch.from_numpy(flow))
    ref = twarp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))
    assert torch.equal(torch.cat([a, b], -1), ref)
    out = _grouped(x, fx, fy, m, 2)
    assert torch.equal(out, twarp.grouped_warp_plain(
        *(torch.from_numpy(t) for t in (x, fx, fy, m)), 2))
    assert (wk.flow_warp.launches, wk.grouped_warp.launches) == (n_fw, n_gw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ca,cb", [(3, 48), (48, 3), (11, 5)])
def test_flow_warp_pair_matches_jax_and_two_warps(dtype, ca, cb):
    """The pair against the JAX package's flow_warp_pair (XLA on JAX-CPU;
    fp32 within ATOL, bf16 within one bf16 ulp) and bit for bit against two
    plain warps; on the CPU it launches no kernel."""
    shape = (2, 9, 40)
    a = torch.from_numpy(_rand(shape + (ca,), 40 + ca)).to(dtype)
    b = torch.from_numpy(_rand(shape + (cb,), 41 + cb)).to(dtype)
    flow = _uniform(shape + (2,), 42, -12, 12)
    flow[1, 4, 7, 1] = 60.0  # far past the bottom border
    tflow = torch.from_numpy(flow)
    n = wk.flow_warp.launches
    out_a, out_b = wk.flow_warp_pair(a, b, tflow)
    assert wk.flow_warp.launches == n
    assert out_a.dtype == out_b.dtype == dtype
    assert torch.equal(out_a, twarp.flow_warp(a, tflow))
    assert torch.equal(out_b, twarp.flow_warp(b, tflow))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref_a, ref_b = jwp.flow_warp_pair(jnp.asarray(a.float().numpy(), jdt),
                                      jnp.asarray(b.float().numpy(), jdt),
                                      jnp.asarray(flow))
    for out, ref in ((out_a, ref_a), (out_b, ref_b)):
        if dtype == torch.float32:
            _close(out, ref)
        else:
            ref = np.asarray(ref, np.float32)
            assert out.shape == ref.shape
            assert (np.abs(out.float().numpy() - ref)
                    <= np.abs(ref) * 2.0 ** -7 + 1e-30).all()


def test_warp_bench_frame_is_the_models(monkeypatch):
    """tools/warp_bench.py times the warp calls of one 1080p P-frame from a
    fixed list; a frame at EL 128x128 / BL 64x64 makes the same calls at
    the shapes scaled by 1/9 in height and 1/15 in width."""
    from lssvc_tpu_torch.models import LSSVC
    from lssvc_tpu_torch.models import components, dmc, lssvc
    from lssvc_tpu_torch.models.init import init_lssvc
    from lssvc_tpu_torch.tools import warp_bench

    calls = []

    def single(x, flow):
        calls.append(("flow_warp", tuple(x.shape)))
        return wk.flow_warp(x, flow)

    def pair(a, b, flow):
        calls.append(("flow_warp_pair", tuple(a.shape) + (b.shape[-1],)))
        return wk.flow_warp_pair(a, b, flow)

    for mod in (components, dmc, lssvc):
        monkeypatch.setattr(mod, "flow_warp", single)
        if hasattr(mod, "flow_warp_pair"):
            monkeypatch.setattr(mod, "flow_warp_pair", pair)
    rng = np.random.default_rng(3)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    model = LSSVC(init_lssvc(torch.Generator().manual_seed(0)),
                  device="cpu", od_offset_cap=10.0)
    model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    model.forward_one_frame(*(torch.from_numpy(rng.random(s, np.float32))
                              for s in shapes))
    assert calls == [(name, (n, h // 9, w // 15, *c))
                     for name, (n, h, w, *c) in warp_bench.FRAME]
