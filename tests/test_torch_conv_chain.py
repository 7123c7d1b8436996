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
import torch.nn.functional as F

import jax.numpy as jnp

from lssvc_tpu.ops import conv_chain as jchain
from lssvc_tpu_torch.convert import chain_specs_from_jax
from lssvc_tpu_torch.ops import conv_chain as tchain
from lssvc_tpu_torch.tools import convchain_bench

from torch_threads import share_cores

share_cores()

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
    the last op writes the output (no slot), and the tool's chain gets the
    tile of least tensor-core work whose chunk-planar slots fit in shared
    memory."""
    rng = np.random.default_rng(14)
    plan = tchain.ConvChain(chain_specs_from_jax(mixed_chain(rng, c=16)), 16,
                            torch.float32, "cpu")
    assert plan.L == 3
    assert [plan.margin[dst] for _, _, dst, *_ in plan.ops] == \
        [2, 2, 1, 1, 0, 0, 0]
    for kind, src, dst, sav, *_ in plan.ops:
        assert plan.slot_of[dst] not in (plan.slot_of[src],
                                         plan.slot_of.get(sav))
    assert plan.slot_of[plan.out_buf] == -1
    _, specs = convchain_bench.make_chain(48, 4, 8, 8, device="cpu")
    for dtype, tile, taps, pad in ((torch.bfloat16, (16, 32), 3, 72),
                                   (torch.float32, (12, 16), 1, 0)):
        plan = tchain.ConvChain(specs, 48, dtype, "cpu")
        assert (plan.L, plan.n_slots) == (4, 2)
        assert plan.in_shared_memory and (plan.tile, plan.taps) == (tile, taps)
        # the input region (L = 4 px of halo), one 16-byte chunk plane per
        # 8 bf16 / 4 f32 channels, bf16 planes padded for the last M tile
        npix = (tile[0] + 8) * (tile[1] + 8)
        assert plan.slot_elems == (npix + pad) * 48
        elt = dtype.itemsize
        stage = (2 if dtype == torch.float32 else 1) * taps * 48 * 48 * elt
        assert plan.ring_bytes == stage
        assert plan.smem_bytes == 2 * stage + 2 * plan.slot_elems * elt
        assert plan.smem_bytes <= tchain.SMEM_BYTES
    # 128 channels in f32 at depth 4 outgrow shared memory
    wide = [{"kind": "conv3", "w": torch.zeros(128, 128, 3, 3)}] * 4
    assert not tchain.ConvChain(wide, 128, torch.float32,
                                "cpu").in_shared_memory


def _unpack_b(packed, k, n, elt):
    """The inverse of the plan's packing: (K, N) from wgmma's K-major core
    matrices."""
    kel = 16 // elt
    return packed.reshape(k // kel, n // 8, 8, kel).permute(0, 3, 1, 2) \
        .reshape(k, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,co,ci", [("conv3", 20, 3), ("conv3", 80, 16),
                                        ("conv1", 24, 40)])
def test_packed_weights_unpack_to_torch_weight(kind, co, ci, dtype):
    """The packed B of a conv, chunk by chunk of <= 64 output channels
    (f32: its TF32 hi part, then its lo part), unpacks to the weight in the
    compute dtype: row (dy*k + dx)*Ci' + ci, column co, zero in the K and N
    padding; in f32 hi = tf32(w), lo = tf32(w - hi) and hi + lo = w."""
    k = 3 if kind == "conv3" else 1
    g = torch.Generator().manual_seed(co + ci)
    w = (torch.randn((co, ci, k, k), generator=g) * 0.3).to(dtype).float()
    plan = tchain.ConvChain([{"kind": kind, "w": w}], ci, dtype, "cpu")
    cin_p, cout_p = -(-ci // 16) * 16, -(-co // 16) * 16
    kk = k * k * cin_p
    packed = plan.wmm.float()
    parts = 2 if dtype == torch.float32 else 1
    assert packed.numel() == parts * kk * cout_p
    cols, off = [], 0
    for n0 in range(0, cout_p, 64):
        nc = min(64, cout_p - n0)
        got = [_unpack_b(packed[off + i * kk * nc:off + (i + 1) * kk * nc],
                         kk, nc, dtype.itemsize) for i in range(parts)]
        off += parts * kk * nc
        if dtype == torch.float32:
            hi, lo = got
            assert torch.equal(hi, tchain.tf32_round(hi))
            assert torch.equal(lo, tchain.tf32_round(lo))
            cols.append(hi + lo)
        else:
            cols.append(got[0])
    b = torch.cat(cols, 1).reshape(k, k, cin_p, cout_p)
    want = torch.zeros(k, k, cin_p, cout_p)
    want[:, :, :ci, :co] = w.permute(2, 3, 1, 0)
    tol = 2.0 ** -21 * float(w.abs().max()) if dtype == torch.float32 else 0
    assert float((b - want).abs().max()) <= tol
    assert not b[:, :, ci:].any() and not b[..., co:].any()


def _tf32(a):
    """Round f32 to TF32 as cvt.rna.tf32.f32 does: keep 10 mantissa bits,
    to nearest, ties away from zero."""
    bits = a.numpy().view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy())


def _tf32_chain(x, specs, passes):
    """The kernel's f32 arithmetic on a conv3 chain, emulated: each operand
    split into hi = tf32(a), lo = tf32(a - hi), the products hi*hi (+ hi*lo
    + lo*hi with three passes) summed in f64, then bias, leaky ReLU and a
    rounding to f32."""
    cur = x.permute(0, 3, 1, 2)
    for s in specs:
        w = s["w"].float()
        a_hi, w_hi = _tf32(cur), _tf32(w)
        terms = [(a_hi, w_hi)]
        if passes == 3:
            terms += [(a_hi, _tf32(w - w_hi)), (_tf32(cur - a_hi), w_hi)]
        y = sum(F.conv2d(a.double(), b.double(), padding=1) for a, b in terms)
        if s.get("b") is not None:
            y = y + s["b"].double()[None, :, None, None]
        if s.get("slope") is not None:
            y = torch.where(y >= 0, y, y * s["slope"])
        cur = y.float()
    return cur.permute(0, 2, 3, 1)


def test_three_tf32_passes_keep_f32_accuracy():
    """Three TF32 products per product (hi*hi + hi*lo + lo*hi) meet the f32
    tolerance against conv_chain_plain, max |err| <= 1e-5 max|ref|; one
    TF32 pass (about 11 bits) does not."""
    rng = np.random.default_rng(17)
    specs = chain_specs_from_jax(uniform_chain(rng, c=16, reps=3))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 12, 13, 16))
                         .astype(np.float32))
    ref = tchain.conv_chain_plain(x, specs)
    top = float(ref.abs().max())
    err3 = float((_tf32_chain(x, specs, 3) - ref).abs().max())
    err1 = float((_tf32_chain(x, specs, 1) - ref).abs().max())
    assert err3 <= 1e-5 * top, (err3, top)
    assert err1 > 1e-5 * top, (err1, top)


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
