"""H-strips compute the same bits as the whole frame (`ops/strips.py`
`conv2d`, `ops/nn.py` `rows_matmul`), on gloo ranks on the CPU.

Each conv shape on strips takes the cheapest of three routes whose rows
a probe on random rows of the level found to be the frame's bits on every
rank: the strip and its halo alone, those rows and `strips.EXTRA_ROWS`
more in a zeroed tensor of the level's height, or the whole level.  The
routes' choice, with frame convs made to depend on a row's place in the
call or on the whole call; the convs of the models on strips against the
frame bit for bit, at strips that start at even and odd rows and at
levels too short to split; then one spatial P-frame (EL 128x128 on 2
ranks) against the port's unsharded frame: every op's output the same
bits (`tools/op_digests.py` finds no op that differs), and so the DPB.
"""

import numpy as np
import pytest
import torch

import torch_dist
from lssvc_tpu_torch.models.init import init_lssvc
from lssvc_tpu_torch.tools.op_digests import first_differences

from torch_threads import share_cores

share_cores()

# frame heights: on 2 ranks strips of 12, 9 (the second starting at an odd
# row) and 3 rows, on 4 of 6 and 9; a strided conv's 9-row output is too
# short to split on 2 or 4 ranks and is computed whole
HEIGHTS = {2: (24, 18, 6), 4: (24, 36)}
CONVS = ("conv3x3", "conv7x7", "conv3x3_s2", "conv1x1_s2_pad0",
         "depthwise3x3", "deconv_s2", "deconv_s1")
EL_HW, BL_HW = (128, 128), (64, 64)


@pytest.fixture(scope="module")
def conv_bits(tmp_path_factory):
    got = {}

    def run(world):
        if world not in got:
            got[world] = torch_dist.run(
                torch_dist.strip_conv_bits, world,
                tmp_path_factory.mktemp(f"c{world}"), HEIGHTS[world], 8)
        return got[world]

    return run


@pytest.fixture(scope="module")
def conv_routes(tmp_path_factory):
    # 42 rows on 2 ranks: the second strip starts at row 21, not a
    # multiple of the tiled conv's 4, and a strip's reach and
    # `strips.EXTRA_ROWS` more (31 rows) do not cover the level
    return torch_dist.run(torch_dist.strip_conv_routes, 2,
                          tmp_path_factory.mktemp("routes"), 42)


@pytest.mark.parametrize("conv, route", [("plain", None),
                                         ("tiled", "embed"),
                                         ("global", "level")])
def test_strip_conv_takes_the_cheapest_route_that_holds(conv_routes, conv,
                                                        route):
    """A conv whose rows read their place in the call takes the zeroed
    level ("embed"), one whose rows read the whole call the whole level;
    every rank takes the same route, and the strips hold the frame's
    bits."""
    taken = {tuple(rank[conv][0]) for rank in conv_routes}
    assert len(taken) == 1 and len(taken.pop()) == 1, conv_routes
    for rank in conv_routes:
        if route is not None:
            assert rank[conv][0] == [route], rank
        assert rank[conv][1], (conv, rank)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("conv", CONVS)
def test_strip_conv_rows_equal_the_frame_rows(conv_bits, world, conv):
    """Each conv of the models on strips is the frame's conv bit for bit,
    on every rank and at every frame height."""
    for rank in conv_bits(world):
        for h in HEIGHTS[world]:
            assert rank[f"{conv}_h{h}"], (world, conv, h)


def test_spatial_frame_ops_equal_the_frame(tmp_path):
    """The spatial P-frame at EL 128x128 on 2 ranks: no op's output
    differs from the port's unsharded frame (`first_differences` empty),
    the DPB and the bits the same."""
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(17)

    def uni(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    x_bl, x_el = uni(1, *BL_HW, 3), uni(1, *EL_HW, 3)
    dpb = {"ref_frame_bl": uni(1, *BL_HW, 3),
           "ref_frame_el": uni(1, *EL_HW, 3),
           "ref_feature_bl": uni(1, *BL_HW, 64),
           "ref_feature_el": uni(1, *EL_HW, 48)}
    args = ({k: v.numpy() for k, v in params.items()}, x_bl, x_el, dpb,
            EL_HW)
    ranks = torch_dist.run(torch_dist.spatial_digests, 2, tmp_path, *args)
    # the frame in a process of a rank's threads: the CPU's convs split
    # their sums by the thread count
    want = torch_dist.run(torch_dist.frame_digests, 1, tmp_path, *args,
                          group=False, threads_of=2)[0]
    assert first_differences(want["records"],
                             [r["records"] for r in ranks]) == []
    for k in torch_dist.DPB_KEYS:
        assert torch.equal(ranks[0]["dpb"][k], want["dpb"][k]), k
    assert ranks[0]["bits"] == want["bits"]
