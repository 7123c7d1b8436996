"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a host without CUDA.  On a GPU host,
`python -m pytest tests/test_torch_cuda.py -q` builds the kernels from
lssvc_tpu_torch/csrc and runs them; nothing here imports JAX.
"""

import numpy as np
import pytest
import torch

from lssvc_tpu_torch.models import LSSVC
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.ops import warp as plain
from lssvc_tpu_torch.ops import warp_kernels as wk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _uniform(shape, seed, lo, hi, dev, dtype=torch.float32):
    a = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_versions(dev, dtype):
    """Bit-equal: the kernels repeat the plain arithmetic with explicit
    round-to-nearest operations."""
    x = _uniform((2, 33, 70, 11), 1, -1, 1, dev, dtype)
    flow = _uniform((2, 33, 70, 2), 2, -40, 40, dev)
    flow[1, 3, 5, 0] = float("nan")
    n = wk.flow_warp.launches
    out = wk.flow_warp(x, flow)
    assert wk.flow_warp.launches == n + 1
    torch.testing.assert_close(out, plain.flow_warp(x, flow), rtol=0, atol=0,
                               equal_nan=True)
    xg = _uniform((1, 21, 37, 48), 3, -1, 1, dev, dtype)
    fx, fy = (_uniform((1, 21, 37, 32), s, -15, 15, dev) for s in (4, 5))
    m = _uniform((1, 21, 37, 32), 6, 0, 1, dev)
    n = wk.grouped_warp.launches
    torch.testing.assert_close(wk.grouped_warp(xg, fx, fy, m, 16),
                               plain.grouped_warp_plain(xg, fx, fy, m, 16),
                               rtol=0, atol=0)
    assert wk.grouped_warp.launches == n + 1


def test_frame_launches_each_kernel(dev):
    """One two-layer P-frame launches flow_warp 14 times and grouped_warp
    once, and agrees with the same weights on the CPU."""
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    args = [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]
    outs = []
    for device in ("cpu", dev):
        model = LSSVC(params, device=device, od_offset_cap=10.0)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        counts = (wk.flow_warp.launches, wk.grouped_warp.launches)
        outs.append(model.forward_one_frame(*(a.to(device) for a in args)))
        delta = (wk.flow_warp.launches - counts[0],
                 wk.grouped_warp.launches - counts[1])
        assert delta == ((14, 1) if device == dev else (0, 0))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        assert abs(float(card[k]) - float(cpu[k])) <= 3e-3 * abs(float(cpu[k]))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 4, 5, 3), device=dev, dtype=torch.float64)
    flow = torch.zeros((1, 4, 5, 2), device=dev)
    with pytest.raises(TypeError):
        wk.flow_warp(x, flow)
    with pytest.raises(ValueError):
        wk.flow_warp(x.float(), flow[..., :1])
    with pytest.raises(ValueError):
        wk.flow_warp(x.float(), flow.cpu())
