"""The port's conv chain against the JAX package's, on the CPU.

`lssvc_tpu_torch.ops.conv_chain.conv_chain_specs` on CPU tensors is the
plain version (F.conv2d in f32 on operands rounded to the compute dtype,
f32 bias, leaky ReLU, one rounding per layer: the CUDA kernel's rounding
points).  It is held against `lssvc_tpu.ops.conv_chain.conv_chain_specs`,
whose Pallas kernel runs in interpret mode here, with the same weights
carried over by `convert.chain_specs_from_jax`.  Tolerances: f32 max |err|
<= 1e-5 max|ref| (summation order); bf16 <= 2^-7 max|ref| (one bf16 ulp
at the largest value, for a rounding that lands the other way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lssvc_tpu.ops import conv_chain as jchain
from lssvc_tpu_torch.convert import chain_specs_from_jax
from lssvc_tpu_torch.ops import conv_chain as tchain
from lssvc_tpu_torch.tools import convchain_bench

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _w(rng, *shape, scale=0.2):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def uniform_chain(rng, c=8, reps=4):
    """The bench tool's chain: conv3 x reps, slope 0.01, no bias."""
    return [{"kind": "conv3", "w": _w(rng, 3, 3, c, c), "b": None,
             "slope": 0.01} for _ in range(reps)]


def mixed_chain(rng, c=16):
    """save, conv3 (bias, slope), a conv1 branch under a tag, dw3, act,
    conv3, add_saved(tag), add_saved; a nonzero bias on every conv."""
    return [
        {"kind": "save"},
        {"kind": "conv3", "w": _w(rng, 3, 3, c, c), "b": _w(rng, c),
         "slope": 0.1},
        {"kind": "conv1", "w": _w(rng, 1, 1, c, c), "b": _w(rng, c),
         "branch": "adapt"},
        {"kind": "dw3", "w": _w(rng, 3, 3, 1, c), "b": _w(rng, c),
         "slope": 0.01},
        {"kind": "act", "slope": 0.2},
        {"kind": "conv3", "w": _w(rng, 3, 3, c, c), "b": _w(rng, c)},
        {"kind": "add_saved", "tag": "adapt"},
        {"kind": "add_saved"},
    ]


def channel_chain(rng):
    """3 -> 16 -> 8 channels, biases and slopes."""
    return [{"kind": "conv3", "w": _w(rng, 3, 3, 3, 16), "b": _w(rng, 16),
             "slope": 0.1},
            {"kind": "conv3", "w": _w(rng, 3, 3, 16, 8), "b": _w(rng, 8),
             "slope": 0.01}]


CASES = {
    "uniform": (uniform_chain, (1, 20, 27, 8)),
    "mixed_unaligned": (mixed_chain, (1, 21, 37, 16)),
    "channels_3_16_8": (channel_chain, (1, 19, 23, 3)),
    "batch2": (uniform_chain, (2, 12, 17, 8)),
}


def _compare(port, ref, rel):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy()
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_chain_specs_matches_jax(case, dt):
    jdt, tdt, rel = DTYPES[dt]
    make, shape = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    specs = make(rng)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    ref = jchain.conv_chain_specs(jnp.asarray(x, jdt), specs)
    out = tchain.conv_chain_specs(torch.from_numpy(x).to(tdt),
                                  chain_specs_from_jax(specs))
    assert out.dtype == tdt
    _compare(out, ref, rel)


def test_conv_chain_uniform_wrapper_matches_jax():
    """conv_chain (the uniform 3x3 wrapper), f32 input, bf16 compute."""
    rng = np.random.default_rng(11)
    specs = uniform_chain(rng, c=8, reps=2)
    x = rng.uniform(0, 1, (1, 10, 13, 8)).astype(np.float32)
    ws = [s["w"] for s in specs]
    ref = jchain.conv_chain(jnp.asarray(x), ws, slopes=[0.01] * 2,
                            cdtype=jnp.bfloat16)
    tws = [s["w"] for s in chain_specs_from_jax(specs)]
    out = tchain.conv_chain(torch.from_numpy(x), tws, slopes=[0.01] * 2,
                            cdtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _compare(out, ref, 2.0 ** -7)


def test_bridge_layouts():
    rng = np.random.default_rng(12)
    specs = [{"kind": "conv3", "w": _w(rng, 3, 3, 4, 6), "b": None},
             {"kind": "conv1", "w": _w(rng, 1, 1, 6, 5), "b": _w(rng, 5)},
             {"kind": "dw3", "w": _w(rng, 3, 3, 1, 5), "tag": "t"}]
    out = chain_specs_from_jax(specs)
    assert out[0]["w"].shape == (6, 4, 3, 3) and out[0]["b"] is None
    assert out[1]["w"].shape == (5, 6, 1, 1)
    assert out[2]["w"].shape == (5, 1, 3, 3) and out[2]["tag"] == "t"
    # HWIO [ky, kx, i, o] is OIHW [o, i, ky, kx]
    assert out[0]["w"][5, 3, 2, 1] == specs[0]["w"][2, 1, 3, 5]
    assert out[2]["w"][4, 0, 1, 2] == specs[2]["w"][1, 2, 0, 4]
    assert torch.equal(out[1]["b"], torch.from_numpy(specs[1]["b"]))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(13)
    specs = chain_specs_from_jax(mixed_chain(rng, c=4))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 7, 9, 4)).astype(np.float32))
    n = tchain.conv_chain.launches
    out = tchain.conv_chain_specs(x, specs)
    plan_out = tchain.ConvChain(specs, 4, torch.float32, "cpu")(x)
    assert tchain.conv_chain.launches == n
    assert torch.equal(out, tchain.conv_chain_plain(x, specs))
    assert torch.equal(plan_out, out)


def test_plan_halo_slots_and_tile():
    """The kernel's plan: halo L = spatial depth (branches count), margins
    shrink by one per spatial layer, an op never writes a slot it reads,
    and the slots of the tool's chain fit in shared memory."""
    rng = np.random.default_rng(14)
    plan = tchain.ConvChain(chain_specs_from_jax(mixed_chain(rng, c=16)), 16,
                            torch.float32, "cpu")
    assert plan.L == 3
    assert [plan.margin[dst] for _, _, dst, *_ in plan.ops] == \
        [2, 2, 1, 1, 0, 0, 0]
    for kind, src, dst, sav, *_ in plan.ops:
        assert plan.slot_of[dst] not in (plan.slot_of[src],
                                         plan.slot_of.get(sav))
    _, specs = convchain_bench.make_chain(48, 4, 8, 8, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        plan = tchain.ConvChain(specs, 48, dtype, "cpu")
        assert (plan.L, plan.n_slots) == (4, 2)
        assert plan.in_shared_memory and plan.tile == (16, 16)
    # 128 channels in f32 at depth 4 outgrow shared memory
    wide = [{"kind": "conv3", "w": torch.zeros(128, 128, 3, 3)}] * 4
    assert not tchain.ConvChain(wide, 128, torch.float32,
                                "cpu").in_shared_memory


def test_plan_rejects_bad_chains():
    rng = np.random.default_rng(15)
    specs = chain_specs_from_jax(channel_chain(rng))
    with pytest.raises(ValueError):  # add_saved across a channel change
        tchain.ConvChain([{"kind": "save"}] + specs + [{"kind": "add_saved"}],
                         3, torch.float32, "cpu")
    with pytest.raises(ValueError):  # weight on the wrong channel count
        tchain.ConvChain(specs[1:], 3, torch.float32, "cpu")
    with pytest.raises(TypeError):  # the kernel computes in f32 or bf16
        tchain.ConvChain(specs, 3, torch.float16, "cpu")


def test_bench_library_chain_matches_plain():
    """The bench tool's unfused chain (its `plain` variant and library
    yardstick) computes the chain in the compute dtype, at a small size."""
    x, specs = convchain_bench.make_chain(8, 2, 9, 11, device="cpu")
    ref = tchain.conv_chain_plain(x, specs)
    lib = convchain_bench.library_chain(x, specs, torch.float32)
    errs = convchain_bench.errors(lib, ref)
    assert errs["max_abs_err"] <= 1e-5 * errs["max_abs_ref"]
    rng = np.random.default_rng(16)
    mixed = chain_specs_from_jax(mixed_chain(rng, c=8))
    xm = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 11, 8)).astype(np.float32))
    errs = convchain_bench.errors(
        convchain_bench.library_chain(xm, mixed, torch.float32),
        tchain.conv_chain_plain(xm, mixed))
    assert errs["max_abs_err"] <= 1e-5 * errs["max_abs_ref"]
