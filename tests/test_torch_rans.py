"""The port's rANS coder (`lssvc_tpu_torch/native`, its own copy of the C++
source, built with g++ into `lssvc_tpu_torch/_build/`) against the JAX
package's binding, in the same process.

Byte-equal streams and equal `pmf_to_quantized_cdf` rows for the same
seeded inputs, symbols that escape the table (bypass coding, down to
+-2^31) included; each binding decodes the other's streams.  Then the
port's own surface: one buffered stream of several tensors, `set_cdf` +
`decode_stream_only_indexes`, the checks on its inputs, and bounded reads
of a corrupt stream.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lssvc_tpu.native import rans as jrans
from lssvc_tpu_torch import build
from lssvc_tpu_torch.native import rans as trans

from torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parents[1]


def _table(rng, n_rows, binding):
    """Random CDF rows through `binding`'s quantizer, zero-padded."""
    rows, offsets = [], []
    for _ in range(n_rows):
        support = int(rng.integers(1, 40))
        pmf = (rng.random(support) + 1e-4).astype(np.float32)
        if rng.random() < 0.3:  # near-degenerate: one symbol has it all
            pmf[:] = 1e-7
            pmf[rng.integers(0, support)] = 1.0
        pmf = pmf / pmf.sum() * (0.9 + 0.1 * rng.random())
        full = np.concatenate([pmf, [max(1.0 - pmf.sum(), 1e-9)]])
        rows.append(binding.pmf_to_quantized_cdf(full.astype(np.float32)))
        offsets.append(int(rng.integers(-50, 10)))
    sizes = np.array([len(r) for r in rows], np.int32)
    mat = np.zeros((n_rows, sizes.max()), np.int32)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = r
    return mat, sizes, np.array(offsets, np.int32)


def _symbols(rng, indexes, sizes, offsets):
    """Half in range, a quarter just past it, a quarter deep escapes."""
    out = np.empty(indexes.size, np.int64)
    for j, i in enumerate(indexes):
        r, lo, hi = rng.random(), offsets[i], offsets[i] + sizes[i] - 2
        if r < 0.5:
            out[j] = rng.integers(lo, hi + 1)
        elif r < 0.75:
            out[j] = rng.integers(lo - 300, hi + 300)
        else:
            out[j] = rng.integers(-2 ** 31, 2 ** 31)
    return out.astype(np.int32)


def test_port_library_is_its_own():
    lib = build.build("lssvc_rans")
    assert lib.parent == build.BUILD_DIR
    assert lib.parent.parent.name == "lssvc_tpu_torch"
    assert lib.name.startswith("liblssvc_rans-") and lib.suffix == ".so"
    assert trans._lib()._name == str(lib)


@pytest.mark.parametrize("seed", range(4))
def test_pmf_to_quantized_cdf_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(2, 80))
        pmf = rng.random(n).astype(np.float32)
        pmf[rng.random(n) < 0.2] = 0.0  # zero slots take a stolen count
        pmf /= max(pmf.sum(), 1e-6) * (1 + 0.1 * rng.random())
        np.testing.assert_array_equal(trans.pmf_to_quantized_cdf(pmf),
                                      jrans.pmf_to_quantized_cdf(pmf))
    with pytest.raises(ValueError, match="degenerate"):
        trans.pmf_to_quantized_cdf(np.zeros(4, np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_streams_equal_jax_and_cross_decode(seed):
    """One buffered stream of three tensors through each binding: the same
    bytes, and each binding decodes the other's."""
    rng = np.random.default_rng(100 + seed)
    mat, sizes, offsets = _table(rng, int(rng.integers(1, 12)), trans)
    tensors = []
    for _ in range(3):
        idx = rng.integers(0, sizes.size, int(rng.integers(1, 600)))
        tensors.append((_symbols(rng, idx, sizes, offsets),
                        idx.astype(np.int32)))
    streams = []
    for binding in (trans, jrans):
        enc = binding.BufferedRansEncoder()
        for sym, idx in tensors:
            enc.encode_with_indexes(sym, idx, mat, sizes, offsets)
        streams.append(enc.flush())
    assert streams[0] == streams[1]
    for decoder in (trans.RansDecoder(), jrans.RansDecoder()):
        for stream in streams:
            decoder.set_stream(stream)
            for sym, idx in tensors:
                np.testing.assert_array_equal(
                    decoder.decode_stream(idx, mat, sizes, offsets), sym)


def test_one_shot_encoder_and_stored_tables():
    rng = np.random.default_rng(7)
    mat, sizes, offsets = _table(rng, 5, trans)
    idx = rng.integers(0, 5, 2000).astype(np.int32)
    sym = _symbols(rng, idx, sizes, offsets)
    stream = trans.RansEncoder().encode_with_indexes(sym, idx, mat, sizes,
                                                     offsets)
    assert stream == jrans.RansEncoder().encode_with_indexes(
        sym, idx, mat, sizes, offsets)
    dec = trans.RansDecoder()
    np.testing.assert_array_equal(
        dec.decode_with_indexes(stream, idx, mat, sizes, offsets), sym)
    with pytest.raises(RuntimeError, match="set_cdf"):
        dec.decode_stream_only_indexes(idx)
    # ragged rows as lists, as the reference's binding takes them
    dec.set_cdf([r[:s] for r, s in zip(mat, sizes)], sizes, offsets)
    dec.set_stream(stream)
    np.testing.assert_array_equal(dec.decode_stream_only_indexes(idx), sym)


def test_inputs_are_checked_before_the_c_call():
    rng = np.random.default_rng(8)
    mat, sizes, offsets = _table(rng, 3, trans)
    enc = trans.BufferedRansEncoder()
    with pytest.raises(ValueError, match="CDF index"):
        enc.encode_with_indexes([0, 1], [0, 3], mat, sizes, offsets)
    with pytest.raises(ValueError, match="2 symbols, 1 indexes"):
        enc.encode_with_indexes([0, 1], [0], mat, sizes, offsets)
    with pytest.raises(ValueError, match="sizes"):
        enc.encode_with_indexes([0], [0], mat, sizes[:2], offsets)
    bad = sizes.copy()
    bad[0] = mat.shape[1] + 1
    with pytest.raises(ValueError, match="outside its row"):
        trans.RansDecoder().decode_stream([0], mat, bad, offsets)


@pytest.mark.parametrize("cut", [0, 3, 17, None])
def test_corrupt_stream_decodes_without_reading_past_it(cut):
    """A truncated or random stream decodes to garbage of the right size:
    the decoder reads zeros past the stream's end."""
    rng = np.random.default_rng(9)
    mat, sizes, offsets = _table(rng, 4, trans)
    idx = rng.integers(0, 4, 5000).astype(np.int32)
    sym = _symbols(rng, idx, sizes, offsets)
    stream = trans.RansEncoder().encode_with_indexes(sym, idx, mat, sizes,
                                                     offsets)
    bad = (bytes(rng.integers(0, 256, 64, dtype=np.uint8)) if cut is None
           else stream[:cut])
    out = trans.RansDecoder().decode_with_indexes(bad, idx, mat, sizes,
                                                  offsets)
    assert out.shape == sym.shape and out.dtype == np.int32


def test_port_loads_its_own_library_only():
    """A fresh interpreter that codes a stream through the port maps the
    port's library, never the JAX package's `liblssvc_rans.so`, and loads
    no JAX."""
    code = r"""
import sys
import numpy as np
from lssvc_tpu_torch.native import RansDecoder, RansEncoder
cdf = np.array([[0, 30000, 65535, 65536]], np.int32)
s = RansEncoder().encode_with_indexes([0, 1, 5], [0, 0, 0], cdf, [4], [0])
assert list(RansDecoder().decode_with_indexes(s, [0, 0, 0], cdf, [4], [0])) \
    == [0, 1, 5]
maps = open("/proc/self/maps").read()
assert "lssvc_tpu_torch/_build/liblssvc_rans-" in maps
assert "lssvc_tpu/native/" not in maps
assert not [n for n in sys.modules if n.split(".")[0] in ("jax", "lssvc_tpu")]
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_coder_rate_on_a_p_frames_symbols(capsys):
    """One 1080p P-frame's 2,263,680 Gaussian symbols (BL 501,120 + EL
    1,762,560) through the video Laplace table, encoded and decoded once:
    the host coder's rate, printed (symbols per second on this CPU)."""
    import time

    from lssvc_tpu_torch.entropy.coder import build_laplace_table

    table = build_laplace_table()
    rng = np.random.default_rng(12)
    n = 2_263_680
    idx = rng.integers(0, 256, n).astype(np.int32)
    sym = np.round(rng.laplace(0, np.exp(rng.uniform(-2, 2, n)))) \
        .astype(np.int32)
    t0 = time.perf_counter()
    enc = trans.BufferedRansEncoder()
    enc.encode_with_indexes(sym, idx, table.cdfs, table.sizes, table.offsets)
    stream = enc.flush()
    t1 = time.perf_counter()
    out = trans.RansDecoder().decode_with_indexes(
        stream, idx, table.cdfs, table.sizes, table.offsets)
    t2 = time.perf_counter()
    np.testing.assert_array_equal(out, sym)
    with capsys.disabled():
        print(f"\nrANS on the CPU: encode {n / (t1 - t0) / 1e6:.1f} M "
              f"symbols/s, decode {n / (t2 - t1) / 1e6:.1f} M symbols/s, "
              f"{8 * len(stream) / n:.2f} bits a symbol")
