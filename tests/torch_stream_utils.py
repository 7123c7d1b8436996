"""Helpers of the stream tests (`tests/test_torch_stream*.py`): the index
planes a coder is handed, and how the port's streams compare with the JAX
package's."""

import numpy as np
import torch


def as_np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def record_indexes(coder, method, arg):
    """Wrap `coder.<method>` so that each call appends its positional
    argument `arg` (an index plane) to the returned list."""
    seen = []
    real = getattr(coder, method)

    def wrapped(*args):
        seen.append(as_np(args[arg]).astype(np.int32))
        return real(*args)

    setattr(coder, method, wrapped)
    return seen


def index_mismatch_share(port, ref, what):
    """The share of scale indexes the port's planes hold that differ from
    the JAX package's, printed and held to 1%."""
    assert [p.shape for p in port] == [r.shape for r in ref]
    n = sum(p.size for p in port)
    diff = sum(int(np.count_nonzero(p != r)) for p, r in zip(port, ref))
    print(f"{what}: {diff} of {n} scale indexes differ from the JAX "
          f"package's ({diff / n:.3%})")
    assert diff <= 0.01 * n
    return diff / n


def assert_bits_close(port, ref, what, rel=0.01):
    """Real bits within 1% of the JAX package's."""
    assert abs(port - ref) <= rel * ref, (what, port, ref)


def table_rows_differ(port, ref, what, max_share=0.1):
    """A port CDF table against the JAX package's: the same shape, sizes
    and offsets; the rows whose CDF differs (a float32 ulp of the probe
    network moves a quantised count) are printed and held to `max_share`
    of the rows."""
    assert port.cdfs.shape == ref.cdfs.shape, what
    np.testing.assert_array_equal(port.sizes, ref.sizes)
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    rows = int(np.count_nonzero((port.cdfs != ref.cdfs).any(axis=1)))
    print(f"{what}: {rows} of {port.cdfs.shape[0]} CDF rows differ from "
          "the JAX package's")
    assert rows <= max_share * port.cdfs.shape[0], (what, rows)
    return rows
