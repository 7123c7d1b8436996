"""`Int8Weight.layout()`, the int8 kernel's copy of an s8 OIHW kernel, on the
CPU: wgmma's K-major core-matrix layout (Cout chunks, taps, 16-channel K
chunks, N rows of 16 bytes), its padding and its alignment."""

import numpy as np
import pytest
import torch

from lssvc_tpu_torch.ops import int8 as q8

from torch_threads import share_cores

share_cores()


def _w8(cout, cin, kh, kw, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, (cout, cin, kh, kw))
                            .astype(np.int8))


def _unpack(lay, kern):
    """The layout back to a padded OIHW kernel (cout_pad, cinp, kh, kw)."""
    nchunks, taps, c16, n, sixteen = lay.shape
    kh, kw = kern.w_q.shape[2:]
    assert sixteen == 16 and taps == kh * kw
    return lay.reshape(nchunks, kh, kw, c16, n, 16).permute(
        0, 4, 3, 5, 1, 2).reshape(nchunks * n, c16 * 16, kh, kw)


# (cout, cin, kh, kw): the int8 frame's kinds of site, Cout 4 / 6 / 8 (one
# 16-wide chunk), 96 and 128 (one chunk), 256, 384 and 512 (chunks of 128),
# Cin 32, 102, 106 and 512 (K padded to 32)
SHAPES = [(96, 96, 3, 3), (128, 128, 1, 1), (4, 128, 3, 3), (6, 96, 3, 3),
          (8, 64, 7, 3), (256, 128, 7, 3), (384, 96, 1, 1), (512, 128, 1, 1),
          (128, 32, 7, 3), (96, 102, 3, 3), (128, 106, 3, 3),
          (128, 512, 1, 1), (64, 96, 1, 1), (16, 48, 3, 3)]


@pytest.mark.parametrize("cout,cin,kh,kw", SHAPES)
def test_layout_unpacks_to_the_kernel(cout, cin, kh, kw):
    w8 = _w8(cout, cin, kh, kw, seed=cout + cin + kh)
    kern = q8.Int8Weight(w8)
    lay = kern.layout()
    assert lay.dtype == torch.int8 and lay.is_contiguous()
    n = q8.chunk_n(cout)
    assert kern.n_chunk == n and kern.cout_pad % n == 0
    assert tuple(lay.shape) == (kern.cout_pad // n, kh * kw, kern.cinp // 16,
                                n, 16)
    full = _unpack(lay, kern)
    assert torch.equal(full[:cout, :cin], w8)
    # the padding of Cin and Cout is zero
    assert not full[cout:].any() and not full[:, cin:].any()


@pytest.mark.parametrize("cout,cin,kh,kw", SHAPES)
def test_layout_element_places(cout, cin, kh, kw):
    """Element [j, ky*kw + kx, c, o, i] is w[j*N + o, 16*c + i, ky, kx]: a
    tap of a Cout chunk is one contiguous run of cinp * N bytes."""
    w8 = _w8(cout, cin, kh, kw, seed=7)
    kern = q8.Int8Weight(w8)
    lay = kern.layout()
    n = kern.n_chunk
    rng = np.random.default_rng(1)
    for _ in range(50):
        o = int(rng.integers(cout))
        c = int(rng.integers(cin))
        ky, kx = int(rng.integers(kh)), int(rng.integers(kw))
        assert lay[o // n, ky * kw + kx, c // 16, o % n, c % 16] == \
            w8[o, c, ky, kx]
    flat = lay.reshape(-1)
    j, t = kern.cout_pad // n - 1, kh * kw - 1
    start = (j * kh * kw + t) * kern.cinp * n
    assert torch.equal(flat[start:start + kern.cinp * n],
                       lay[j, t].reshape(-1))


@pytest.mark.parametrize("cout,want", [(1, 16), (4, 16), (8, 16), (16, 16),
                                       (17, 32), (32, 32), (48, 64),
                                       (64, 64), (65, 96), (96, 96),
                                       (97, 128), (128, 128), (256, 128),
                                       (384, 128), (512, 128)])
def test_cout_chunks(cout, want):
    """The Cout chunk is the narrowest of 16, 32, 64, 96, 128 that holds
    Cout, else 128 (several chunks); Cin pads to a multiple of 32."""
    assert q8.chunk_n(cout) == want
    kern = q8.Int8Weight(torch.zeros((cout, 40, 1, 1), dtype=torch.int8))
    assert kern.cout_pad == -(-cout // want) * want
    assert kern.cinp == 64


def test_layout_is_built_once():
    kern = q8.Int8Weight(_w8(96, 96, 3, 3))
    assert kern.layout() is kern.layout()
