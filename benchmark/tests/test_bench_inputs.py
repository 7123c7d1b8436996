"""The traffic generator and the weights are fixed by `--seed`."""

import pytest
import torch

from benchmark.lib import traffic, weights

MIX = {"generator": "synthetic_motion", "frames": 3, "texture_cell": 16,
       "pan_px_per_frame": 1.5, "square_px_per_frame": [3, 4],
       "bit_depth": 8}
CONFIG = {"height": 96, "width": 160, "ratio": 2.0}


def test_same_seed_same_frames_other_seed_other_frames():
    seed = 2 ** 31 + 12345  # more than 32 signed bits hold
    a = traffic.make_frames(MIX, CONFIG, seed, "cpu")
    b = traffic.make_frames(MIX, CONFIG, seed, "cpu")
    c = traffic.make_frames(MIX, CONFIG, seed + 1, "cpu")
    for xa, xb, xc in zip(a[1], b[1], c[1]):
        assert torch.equal(xa, xb)
        assert not torch.equal(xa, xc)
    for xa, xb in zip(a[0], b[0]):
        assert torch.equal(xa, xb)


def test_frames_are_padded_8bit_420_and_in_range():
    bl, el = traffic.make_frames(MIX, CONFIG, 7, "cpu")
    pad = traffic.interlayer_padding(96, 160, 2.0)
    assert pad == {"el": (128, 256), "bl": (64, 128)}
    assert tuple(el[0].shape) == (1, 128, 256, 3)
    assert tuple(bl[0].shape) == (1, 64, 128, 3)
    assert float(el[0].min()) >= 0 and float(el[0].max()) <= 1
    # zero padding below and right of the picture
    assert float(el[0][0, 96:].abs().max()) == 0
    assert float(el[0][0, :, 160:].abs().max()) == 0
    # the frames differ by motion, every seed by the same amount
    assert not torch.equal(el[0], el[1])


def test_padding_matches_the_x1_5_layers():
    assert traffic.interlayer_padding(1080, 1920, 1.5) == {
        "el": (1152, 1920), "bl": (768, 1280)}
    assert traffic.interlayer_padding(1080, 1920, 2.0) == {
        "el": (1152, 1920), "bl": (576, 960)}


def test_weights_from_the_seed_in_two_draws():
    d = weights.init_lssvc(weights.Draws())
    a = weights.Draws.realize(d, 2 ** 40 + 3, "cpu")
    b = weights.Draws.realize(weights.init_lssvc(weights.Draws()),
                              2 ** 40 + 3, "cpu")
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    n = sum(v.numel() for v in a.values())
    assert abs(n - 29.44e6) < 0.01e6
    # GDN at identity and bias 0.01, as the program's init makes them
    assert float(a["base_layer_model.mv_encoder.1.beta"].min()) > 0.99
    bias = a["base_layer_model.mv_encoder.0.bias"]
    assert float(bias[0]) == pytest.approx(0.01)


def test_weights_have_the_programs_shapes():
    from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc

    g = torch.Generator().manual_seed(0)
    for mine, theirs in ((weights.init_lssvc(weights.Draws()),
                          init_lssvc(g)),
                         (weights.init_intra_ss(weights.Draws(), 192),
                          init_intra_ss(g, 192))):
        assert set(mine) == set(theirs)
        assert all(tuple(mine[k].shape) == tuple(theirs[k].shape)
                   for k in mine)
