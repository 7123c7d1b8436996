"""LSSVC enhancement-layer building blocks (the JAX package's
`models/lssvc_blocks.py`), in both domains: the full-res stacks run
width-packed where the current mode has packed width 2.

The channel plan g_ch = 48/64/96/96/128 for 1x/2x/4x/8x/16x scales, the
OffsetDiversity group-warp aligner, inter-layer resamplers, hybrid weight
generator, and the MV conditional coding transforms.

OffsetDiversity's 32 grouped warps run as one `grouped_warp` launch in
block channel layout (c' = k*32 + unit), and the grouped 1x1 fusion conv is
the same dense scatter-matrix product as in the JAX package, so the fusion
consumes the block layout directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import (
    bilinear_resize,
    bilinear_upsample2,
    grouped_warp,
    leaky_relu,
)
from ..ops.nn import matmul_f32out, packed_width
from ..ops.packed import pack_width, unpack_width
from .components import (
    cat,
    conv,
    depth_conv_block,
    gdn_p,
    res_block,
    subpel_conv,
    unet,
)
from .packed_blocks import (
    aux_pair_perm,
    p_conv_seq3,
    p_depth_conv_block,
    p_res_block,
    packed_region,
    pconv,
)


def conv_seq3(p, x, stride0=1):
    """Sequential(conv, leaky, conv) — indices 0, 2."""
    f = conv(p.sub("0"), x, stride=stride0)
    f = leaky_relu(f, 0.01)
    return conv(p.sub("2"), f)


@functools.lru_cache(maxsize=8)
def _offset_fusion_scatter(group_num: int, offset_num: int, cg: int):
    """Static (C_in', C_out, U) 0/1 tensor mapping the grouped fusion conv
    onto a dense product over the block-layout warped tensor.

    Torch semantics (`lssvc_modules.py:90,103-110`): fusion is a 1x1 conv
    with `group_num` groups over channels c = j*cg + t (unit-major); its
    group g consumes warp units j in {offset_num*g + d} and produces
    channels [cg*g, cg*(g+1)).  The warped tensor uses block layout
    c' = k*go + j, so scatter[c', o, u] = 1 iff input c' is the u-th
    in-group input of o's group."""
    go = group_num * offset_num
    c_out = group_num * cg
    u_per_group = offset_num * cg
    scat = np.zeros((go * cg, c_out, u_per_group), dtype=np.float32)
    for g in range(group_num):
        for d in range(offset_num):
            j = offset_num * g + d
            for k in range(cg):
                scat[k * go + j, cg * g:cg * (g + 1), d * cg + k] = 1.0
    return scat


def offset_diversity(p, x, aux_feature, flow, group_num=16, offset_num=2,
                     max_residue_magnitude=40.0, offset_cap=None,
                     aux_pair_packed=None, mv_packed=None):
    """Group-wise multi-offset warp with masks (`lssvc_modules.py:75-112`).

    `offset_cap` (px) clips the diversity offsets (the serving preset is
    10, `ops.nn.OD_OFFSET_CAP_SERVING`); None leaves them uncapped.

    `aux_pair_packed` (with `mv_packed`, aux_feature None): the aux tensor
    arrives already packed, as the fused packed pair warp's (N, H, W/2,
    2*(3+48)) store and the packed mv; the entry conv reads their concat
    through a permutation of its packed kernel's input channels
    (`aux_pair_perm`), with no relayout of the pair."""
    cg = x.shape[-1] // group_num  # channels per group (3)

    if aux_pair_packed is not None:
        c_pair = aux_pair_packed.shape[-1] // 2
        aux_p = torch.cat([aux_pair_packed, mv_packed.to(
            aux_pair_packed.dtype)], dim=-1)
        out = unpack_width(
            pconv(p.sub("conv_offset.0"), aux_p, stride=2,
                  in_perm=aux_pair_perm(c_pair, c_pair + 2)), 2)
    elif packed_width() == 2 and aux_feature.shape[2] % 4 == 0:
        # % 4, not % 2: the stride-2 packed conv is exact only when the
        # packed width W/2 is itself even (the JAX package's
        # `lssvc_blocks.py:130-135`)
        out = unpack_width(pconv(p.sub("conv_offset.0"),
                                 pack_width(aux_feature, 2), stride=2), 2)
    else:
        out = conv(p.sub("conv_offset.0"), aux_feature, stride=2)
    out = leaky_relu(out, 0.1)
    out = conv(p.sub("conv_offset.2"), out)
    out = leaky_relu(out, 0.1)
    out = conv(p.sub("conv_offset.4"), out)
    out = bilinear_upsample2(out)

    o1, o2, mask = torch.chunk(out, 3, dim=-1)  # 32 ch each
    mask = torch.sigmoid(mask)
    # Python floats, so the offsets keep the conv's dtype as in the JAX
    # package (`lssvc_blocks.py:154-159`): a 0-dim f32 tensor here would
    # give bf16 in torch but f32 in JAX (torch treats a 0-dim tensor like
    # a scalar)
    offset = torch.tanh(cat([o1, o2])) * float(max_residue_magnitude)
    if offset_cap:
        offset = torch.clamp(offset, -float(offset_cap), float(offset_cap))
    # offset channel 2j is unit j's dx, 2j+1 its dy; add the base flow
    flow_x = offset[..., 0::2] + flow[..., 0:1]  # (B, H, W, 32)
    flow_y = offset[..., 1::2] + flow[..., 1:2]

    # one launch; block layout c' = k*go + j, go = group_num*offset_num
    warped = grouped_warp(x, flow_x, flow_y, mask, group_num)

    wg = p("fusion.weight")  # (C_out, offset_num*cg, 1, 1) grouped OIHW
    scat = torch.from_numpy(
        _offset_fusion_scatter(group_num, offset_num, cg)).to(wg)
    dense = torch.einsum("ou,iou->io", wg[:, :, 0, 0], scat)
    # operands in the compute dtype, f32 out (`lssvc_blocks.py:178-187`)
    return matmul_f32out(warped, dense) + p("fusion.bias")


def hybrid_weight_generator(p, ctx_temp, ctx_spat):
    """Per-scale softmax blending maps (`lssvc_modules.py:115-154`)."""
    maps_t, maps_s = [], []
    for i in (1, 2, 3):
        g = p.sub(f"generator{i}")
        f = cat([ctx_temp[i - 1], ctx_spat[i - 1]])
        if packed_width() == 2 and i <= 2:
            # the 1x and 2x generators run packed; the 4x one stays plain
            def stack(xp, g=g):
                fp = pconv(g.sub("0"), xp)
                fp = p_res_block(g.sub("1"), fp, end_with_relu=True)
                return pconv(g.sub("2"), fp)

            f = packed_region(f, stack)
        else:
            f = conv(g.sub("0"), f)
            f = res_block(g.sub("1"), f, end_with_relu=True)
            f = conv(g.sub("2"), f)
        wmap = torch.softmax(f, dim=-1)
        maps_t.append(wmap[..., 0:1])
        maps_s.append(wmap[..., 1:2])
    return maps_t, maps_s


def _resampler_tail(p, up):
    """Full-res tail shared by the resamplers: conv_seq3 + two
    DepthConvBlock refines; under packed width 2 both come back packed."""
    if packed_width() == 2:
        fp = p_conv_seq3(p.sub("conv2"), pack_width(up.contiguous(), 2))
        rp = p_depth_conv_block(p.sub("feature_refine.0"), fp)
        rp = p_depth_conv_block(p.sub("feature_refine.1"), rp)
        return rp, fp
    f = conv_seq3(p.sub("conv2"), up)
    refine = depth_conv_block(p.sub("feature_refine.0"), f)
    refine = depth_conv_block(p.sub("feature_refine.1"), refine)
    return refine, f


def mv_resampler(p, mv_bl, shape_hr, s):
    """BL motion -> EL grid, scaled by s (`lssvc_modules.py:339-365`)."""
    f0 = conv_seq3(p.sub("conv1"), mv_bl)
    up = bilinear_resize(f0, shape_hr)
    refine, f = _resampler_tail(p, up)
    if packed_width() == 2:
        mv = unpack_width(pconv(p.sub("recon_conv"), refine + f), 2)
    else:
        mv = conv(p.sub("recon_conv"), refine + f)
    return mv * float(s)  # a Python float, as in the JAX package


def texture_resampler(p, texture_bl, shape_hr):
    """BL texture -> EL grid (`lssvc_modules.py:368-397`); adaptor choice is
    by input channel count (64 = base-layer feature)."""
    key = ("conv_adaptor.base_layer_adaptor"
           if texture_bl.shape[-1] == 64 else "conv_adaptor.enhance_layer_adaptor")
    f = conv(p.sub(key), texture_bl)
    f = conv_seq3(p.sub("conv1"), f)
    up = bilinear_resize(f, shape_hr)
    refine, up_f = _resampler_tail(p, up)
    if packed_width() == 2:
        return unpack_width(refine + up_f, 2)
    return refine + up_f


def layer_prior_resampler(p, y_hat_bl, shape_hr_16):
    """BL latent -> EL latent-grid prior (`lssvc_modules.py:400-429`)."""
    key = ("conv_adaptor.base_layer_adaptor"
           if y_hat_bl.shape[-1] == 96 else "conv_adaptor.enhance_layer_adaptor")
    f = conv(p.sub(key), y_hat_bl)
    f = conv_seq3(p.sub("conv1"), f)
    up = bilinear_resize(f, shape_hr_16)
    up = conv_seq3(p.sub("conv2"), up)
    refine = depth_conv_block(p.sub("feature_refine.0"), up)
    refine = depth_conv_block(p.sub("feature_refine.1"), refine)
    return refine + up


def prior_fusion(p, hyper_prior, temporal_prior, layer_prior):
    """Fuse three priors with two DepthConvBlocks (`lssvc_modules.py:432-442`)."""
    f = cat([hyper_prior, temporal_prior, layer_prior])
    f = depth_conv_block(p.sub("prior_fusion_conv.0"), f)
    return depth_conv_block(p.sub("prior_fusion_conv.1"), f)


def mv_res_encoder(p, mv, mv_ctx):
    """Conditional MV analysis (`lssvc_modules.py:445-469`)."""
    e1 = p.sub("encoder1")
    f = conv(e1.sub("0"), mv, stride=2)
    f = gdn_p(e1.sub("1"), f)
    f = res_block(e1.sub("2"), f, start_from_relu=False)
    f = leaky_relu(f, 0.1)
    e2 = p.sub("encoder2")
    f = cat([f, mv_ctx])
    f = conv(e2.sub("0"), f, stride=2)
    f = gdn_p(e2.sub("1"), f)
    f = res_block(e2.sub("2"), f, start_from_relu=False)
    f = leaky_relu(f, 0.1)
    f = conv(e2.sub("4"), f, stride=2)
    f = gdn_p(e2.sub("5"), f)
    f = res_block(e2.sub("6"), f, start_from_relu=False)
    f = leaky_relu(f, 0.1)
    return conv(e2.sub("8"), f, stride=2)


def mv_res_decoder(p, mv_y_hat, mv_ctx):
    """Conditional MV synthesis (`lssvc_modules.py:472-494`)."""
    d1 = p.sub("decoder1")
    f = subpel_conv(d1.sub("0"), mv_y_hat, 2)
    f = leaky_relu(f, 0.1)
    f = res_block(d1.sub("2"), f, start_from_relu=False)
    f = gdn_p(d1.sub("3"), f, inverse=True)
    f = subpel_conv(d1.sub("4"), f, 2)
    f = gdn_p(d1.sub("5"), f, inverse=True)
    f = subpel_conv(d1.sub("6"), f, 2)
    f = gdn_p(d1.sub("7"), f, inverse=True)
    d2 = p.sub("decoder2")
    f = cat([f, mv_ctx])
    f = conv(d2.sub("0"), f)
    f = leaky_relu(f, 0.1)
    return subpel_conv(d2.sub("2"), f, 2)


def mv_context_transformer(p, mv_upsample):
    f = conv(p.sub("transform.0"), mv_upsample, stride=2)
    return res_block(p.sub("transform.1"), f, start_from_relu=True)


def el_res_encoder(p, x, c1, c2, c3):
    """GDN-free conditional analysis (`lssvc_modules.py:235-254`)."""
    f = conv(p.sub("conv1"), cat([x, c1]), stride=2)
    f = res_block(p.sub("res1"), cat([f, c2]), slope=0.1, end_with_relu=True)
    f = conv(p.sub("conv2"), f, stride=2)
    f = res_block(p.sub("res2"), cat([f, c3]), slope=0.1, end_with_relu=True)
    f = conv(p.sub("conv3"), f, stride=2)
    return conv(p.sub("conv4"), f, stride=2)


def el_res_decoder(p, y_hat, c2, c3):
    """GDN-free conditional synthesis (`lssvc_modules.py:257-276`)."""
    f = subpel_conv(p.sub("up1"), y_hat, 2)
    f = subpel_conv(p.sub("up2"), f, 2)
    f = res_block(p.sub("res1"), cat([f, c3]), slope=0.1, end_with_relu=True)
    f = subpel_conv(p.sub("up3"), f, 2)
    f = res_block(p.sub("res2"), cat([f, c2]), slope=0.1, end_with_relu=True)
    return subpel_conv(p.sub("up4"), f, 2)


def el_recon_generation(p, ctx, res):
    """first_conv + 2 UNets + recon conv (`lssvc_modules.py:279-292`)."""
    if packed_width() == 2:
        f = packed_region(cat([ctx, res]),
                          lambda xp: pconv(p.sub("first_conv"), xp))
        f = unet(p.sub("unet_1"), f)
        f = unet(p.sub("unet_2"), f)
        return f, packed_region(f, lambda xp: pconv(p.sub("recon_conv"), xp))
    f = conv(p.sub("first_conv"), cat([ctx, res]))
    f = unet(p.sub("unet_1"), f)
    f = unet(p.sub("unet_2"), f)
    recon = conv(p.sub("recon_conv"), f)
    return f, recon
