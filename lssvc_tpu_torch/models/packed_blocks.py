"""Width-packed variants of the full-resolution conv blocks (the JAX
package's `models/packed_blocks.py`), with their int8 sites.

Mirrors of `components.py` blocks that run on width-packed tensors
(`ops/packed.py`: (N, H, W/p, p*C)), drop-in replacements inside a
`pack_width -> blocks -> unpack_width` region, taken where the model's mode
has packed width 2.  The packed kernels are built from the same f32
weights, once per model and mode: they live in the mode's cache (the
model's, `models/base.py`), keyed by the weight tensor, the pack factor,
the stride and the input permutation.

Every packed conv is a site of the int8 precision: its input absmax is
recorded while the model's recorder is open, and in "int8" a site whose
key (`ops.int8.calib_key`) has a scale in the model's table runs the s8
convolution (`_pconv_int8`); any other site runs the float path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import leaky_relu
from ..ops.int8 import (Int8Weight, calib_key, f32_scalar, int8_conv2d,
                        quant_weight)
from ..ops.nn import current_mode
from ..ops.packed import (
    pack_bias,
    pack_depthwise_kernel_oihw,
    pack_kernel_oihw,
    pack_width,
    packed_conv2d,
    unpack_width,
)

P = 2  # pack factor: doubles the channel dim, halves rows


def _cached(key, w, build):
    """`build()` through the mode's cache, under `key`; an entry keeps its
    weight tensor, so a replaced weight is built anew."""
    cache = current_mode().cache
    hit = None if cache is None else cache.get(key)
    if hit is not None and hit[0] is w:
        return hit[1]
    value = build()
    if cache is not None:
        cache[key] = (w, value)
    return value


def _permuted(pw, in_perm):
    # our input channel j carries what the standard packed layout calls
    # channel in_perm[j]
    if in_perm is None:
        return pw
    return pw[:, torch.from_numpy(in_perm).to(pw.device)]


def _perm_key(in_perm):
    return None if in_perm is None else in_perm.tobytes()


def _packed(scope, key, w, p, stride, in_perm, pack_fn):
    """The packed (kernel, bias, padding) of `scope`'s conv, from the mode's
    cache (built on a miss)."""
    def build():
        pw, pads = pack_fn(w, p, stride)
        return (_permuted(pw, in_perm).contiguous(),
                pack_bias(scope(key + "bias"), p), pads)

    # keyed by the weight itself: the BL and the EL share scope names
    return _cached((id(w), p, stride, _perm_key(in_perm)), w, build)


def _pconv_int8(scope, key, x_pk, w, s_in, p, stride, in_perm, pack_fn):
    """w8a8 integer conv of a calibrated site (the JAX package's
    `_pconv_int8`, `packed_blocks.py:35-53`): the kernel quantized per
    output channel on the unpacked kernel, then packed (a depthwise one
    densified), then gathered by `in_perm`; the input quantized per tensor
    by `s_in` as the kernel loads it; y = f32(acc) * (f32(s_in) *
    tile(w_scale, p)) + packed bias, in bf16."""
    def build():
        w8, w_scale = quant_weight(w)
        pw8, pads = pack_fn(w8, p, stride)
        mult = f32_scalar(s_in, w.device) * w_scale.repeat(p)
        return (Int8Weight(_permuted(pw8, in_perm), mult,
                           pack_bias(scope(key + "bias"), p).float()), pads)

    kern, (pl, pr) = _cached(("int8", id(w), p, stride, _perm_key(in_perm),
                              s_in), w, build)
    kh = w.shape[2]
    return int8_conv2d(x_pk, kern, stride=stride,
                       padding=((kh // 2, kh // 2), (pl, pr)), s_in=s_in)


def _site(scope, key, x_pk, w, p, stride, in_perm, pack_fn):
    """A packed conv site: recorded, then int8 where calibrated, else the
    float path."""
    mode = current_mode()
    ckey = calib_key(scope.prefix + key, w)
    mode.int8.record(ckey, x_pk)
    s_in = mode.int8.scale_for(ckey) if mode.precision == "int8" else None
    if s_in is not None:
        return _pconv_int8(scope, key, x_pk, w, s_in, p, stride, in_perm,
                           pack_fn)
    pw, pb, pads = _packed(scope, key, w, p, stride, in_perm, pack_fn)
    return packed_conv2d(x_pk, pw, pb, stride=stride, pad_lr=pads)


def pconv(scope, x_pk, stride: int = 1, p: int = P, in_perm=None):
    """Packed conv from a weight/bias scope (stride 1 or 2, odd kernels).

    `in_perm` (optional int array, len p*Cin): the caller's packed input
    channel j carries what the standard packed layout calls channel
    in_perm[j]; the packed kernel's input dim is gathered accordingly (once,
    in the cache), so a consumer reads a concat of independently packed
    tensors without a relayout."""
    return _site(scope, "", x_pk, scope("weight"), p, stride, in_perm,
                 pack_kernel_oihw)


def pconv_dw(scope, x_pk):
    """Packed depthwise 3x3 (densified; see pack_depthwise_kernel)."""
    return _site(scope, "depth_conv.", x_pk, scope("depth_conv.weight"), P,
                 1, None, pack_depthwise_kernel_oihw)


def p_res_block(scope, x_pk, slope=0.01, start_from_relu=True,
                end_with_relu=False):
    out = leaky_relu(x_pk, slope) if start_from_relu else x_pk
    out = pconv(scope.sub("conv1"), out)
    out = leaky_relu(out, slope)
    out = pconv(scope.sub("conv2"), out)
    if end_with_relu:
        out = leaky_relu(out, slope)
    return x_pk + out


def p_depth_conv(scope, x_pk, slope=0.01):
    if "adaptor.weight" in scope:
        identity = pconv(scope.sub("adaptor"), x_pk)
    else:
        identity = x_pk
    out = pconv(scope.sub("conv1.0"), x_pk)
    out = leaky_relu(out, slope)
    out = pconv_dw(scope, out)
    out = pconv(scope.sub("conv2"), out)
    return out + identity


def p_conv_ffn(scope, x_pk, slope=0.1):
    out = pconv(scope.sub("conv.0"), x_pk)
    out = leaky_relu(out, slope)
    out = pconv(scope.sub("conv.2"), out)
    out = leaky_relu(out, slope)
    return x_pk + out


def p_depth_conv_block(scope, x_pk, slope_depth_conv=0.01, slope_ffn=0.1):
    x_pk = p_depth_conv(scope.sub("block.0"), x_pk, slope=slope_depth_conv)
    return p_conv_ffn(scope.sub("block.1"), x_pk, slope=slope_ffn)


def p_conv_seq3(scope, x_pk):
    f = pconv(scope.sub("0"), x_pk)
    f = leaky_relu(f, 0.01)
    return pconv(scope.sub("2"), f)


def packed_region(x, fn):
    """pack -> fn -> unpack around a stride-1 full-res stack."""
    return unpack_width(fn(pack_width(x.contiguous(), P)), P)


def aux_pair_perm(c_pair: int, c_aux: int) -> np.ndarray:
    """Input-channel permutation of OffsetDiversity's packed entry conv
    when its aux tensor arrives as concat([pair_packed, mv_packed]) instead
    of pack_width(concat([c1_init, warpframe, mv])) (the JAX package's
    `lssvc_blocks.py:_aux_pair_perm`).

    Pair layout (phase si, channel c'): si*c_pair + c', with c' < 3 the
    warped reference frame and c' >= 3 the warped f1 (the pair warp's
    source order [ref_el, f1]); mv follows at 2*c_pair + si*2 + m.  The
    standard packed aux layout is si*c_aux + c with c < c_aux-5 = c1_init,
    then warpframe (3), then mv (2).  idx[j] is the standard packed index
    whose value our channel j carries."""
    c1 = c_aux - 5  # c1_init channels (48)
    idx = np.zeros(2 * c_pair + 4, dtype=np.int64)
    for si in range(2):
        for c in range(c_aux):
            q = si * c_aux + c  # standard packed index
            if c < c1:  # c1_init channel c -> pair channel 3 + c
                j = si * c_pair + 3 + c
            elif c < c1 + 3:  # warpframe -> pair channel c - c1
                j = si * c_pair + (c - c1)
            else:  # mv channel m, packed separately after the pair
                j = 2 * c_pair + si * 2 + (c - c1 - 3)
            idx[j] = q
    return idx
