"""Shared network blocks as pure NHWC functions over scoped parameters.

The JAX package's `models/components.py`.  Every function takes a `P`
scope whose keys follow the reference's torch module naming; sequential
containers index all submodules (activations included), matching torch
nn.Sequential key numbering.  Where the current mode has packed width 2
(`ops.nn.packed_width`), the full-res stride-1 stacks run in the
width-packed domain (`models/packed_blocks.py`), as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops import (
    avg_pool2d,
    bilinear_downsample2,
    bilinear_upsample2,
    conv2d,
    conv_transpose2d,
    flow_warp,
    gdn,
    leaky_relu,
    max_pool2d,
    pixel_shuffle,
    relu,
)
from ..ops.nn import packed_width
from ..ops.packed import pack_width, unpack_width
from .packed_blocks import (
    p_depth_conv_block,
    p_res_block,
    packed_region,
    pconv,
)


def conv(p, x, stride=1, padding=None, groups=1):
    """Conv2d from a scope holding weight/bias."""
    return conv2d(x, p("weight"), p("bias"), stride=stride, padding=padding,
                  groups=groups)


def deconv(p, x, stride=2, padding=1, output_padding=1):
    return conv_transpose2d(x, p("weight"), p("bias"), stride=stride,
                            padding=padding, output_padding=output_padding)


def gdn_p(p, x, inverse=False):
    return gdn(x, p("beta"), p("gamma"), inverse=inverse)


def subpel_conv(p, x, r: int):
    """subpel_conv3x3/1x1: conv to C*r^2 then pixel shuffle (scope idx 0)."""
    return pixel_shuffle(conv(p.sub("0"), x), r)


def cat(ts):
    return torch.cat(ts, dim=-1)


# ---------------------------------------------------------------------------
# Residual blocks

def res_block(p, x, slope=0.01, start_from_relu=True, end_with_relu=False):
    """ResBlock (`video_net_component.py:170-188`); bottleneck-ness is
    implied by the conv1 weight shape."""
    out = leaky_relu(x, slope) if start_from_relu else x
    out = conv(p.sub("conv1"), out)
    out = leaky_relu(out, slope)
    out = conv(p.sub("conv2"), out)
    if end_with_relu:
        out = leaky_relu(out, slope)
    return x + out


def residual_block(p, x, slope=0.01):
    """Two 3x3 convs with leaky relu after each (`layers.py:122-145`)."""
    out = conv(p.sub("conv1"), x)
    out = leaky_relu(out, slope)
    out = conv(p.sub("conv2"), out)
    out = leaky_relu(out, slope)
    return out + x


def residual_block_with_stride(p, x, stride=2):
    """conv(s) -> leaky -> conv -> GDN, 1x1-strided shortcut when the block
    has one (`layers.py:60-91`)."""
    out = conv(p.sub("conv1"), x, stride=stride)
    out = leaky_relu(out, 0.01)
    out = conv(p.sub("conv2"), out)
    out = gdn_p(p.sub("gdn"), out)
    identity = (conv(p.sub("downsample"), x, stride=stride)
                if "downsample.weight" in p else x)
    return out + identity


def residual_block_upsample(p, x, r=2):
    """subpel -> leaky -> conv -> IGDN with a subpel shortcut
    (`layers.py:94-119`)."""
    out = subpel_conv(p.sub("subpel_conv"), x, r)
    out = leaky_relu(out, 0.01)
    out = conv(p.sub("conv"), out)
    out = gdn_p(p.sub("igdn"), out, inverse=True)
    identity = subpel_conv(p.sub("upsample"), x, r)
    return out + identity


# ---------------------------------------------------------------------------
# Depthwise conv blocks

def depth_conv(p, x, stride=1, slope=0.01):
    """1x1 -> leaky -> depthwise 3x3 -> 1x1 with adaptive shortcut
    (`lssvc_modules.py:15-43`)."""
    if "adaptor.weight" in p:
        if stride != 1:
            identity = conv(p.sub("adaptor"), x, stride=2, padding=0)
        else:
            identity = conv(p.sub("adaptor"), x)
    else:
        identity = x
    out = conv(p.sub("conv1.0"), x, stride=stride)
    out = leaky_relu(out, slope)
    dw = p("depth_conv.weight")
    out = conv2d(out, dw, p("depth_conv.bias"), groups=dw.shape[0])
    out = conv(p.sub("conv2"), out)
    return out + identity


def conv_ffn(p, x, slope=0.1):
    out = conv(p.sub("conv.0"), x)
    out = leaky_relu(out, slope)
    out = conv(p.sub("conv.2"), out)
    out = leaky_relu(out, slope)
    return x + out


def depth_conv_block(p, x, stride=1, slope_depth_conv=0.01, slope_ffn=0.1):
    x = depth_conv(p.sub("block.0"), x, stride=stride, slope=slope_depth_conv)
    return conv_ffn(p.sub("block.1"), x, slope=slope_ffn)


def unet(p, x):
    """Two-level UNet of DepthConvBlocks (`lssvc_modules.py:295-336`); the
    two full-res DepthConvBlocks (conv1, up_conv2) run width-packed under
    packed width 2."""
    packed = packed_width() == 2
    if packed:
        x1 = packed_region(
            x, lambda xp: p_depth_conv_block(p.sub("conv1"), xp))
    else:
        x1 = depth_conv_block(p.sub("conv1"), x)
    x2 = max_pool2d(x1, 2)
    x2 = depth_conv_block(p.sub("conv2"), x2)
    x3 = max_pool2d(x2, 2)
    x3 = depth_conv_block(p.sub("conv3"), x3)
    for i in range(4):
        x3 = depth_conv_block(p.sub(f"context_refine.{i}"), x3)
    d3 = subpel_conv(p.sub("up3"), x3, 2)
    d3 = depth_conv_block(p.sub("up_conv3"), cat([x2, d3]))
    d2 = subpel_conv(p.sub("up2"), d3, 2)
    if packed:
        return packed_region(
            cat([x1, d2]),
            lambda xp: p_depth_conv_block(p.sub("up_conv2"), xp))
    return depth_conv_block(p.sub("up_conv2"), cat([x1, d2]))


# ---------------------------------------------------------------------------
# Multi-scale feature extraction / fusion (shared by DMC and LSSVC)

def feature_extractor_3scale(p, x, slope=0.01):
    """conv/res x3 with stride-2 between scales (`dmc_net.py:11-31`); the
    full-res conv and ResBlock run width-packed under packed width 2."""
    if packed_width() == 2:
        def tail(xp):
            f = pconv(p.sub("conv1"), xp)
            return p_res_block(p.sub("res_block1"), f, slope)

        l1 = packed_region(x, tail)
    else:
        l1 = conv(p.sub("conv1"), x)
        l1 = res_block(p.sub("res_block1"), l1, slope)
    l2 = conv(p.sub("conv2"), l1, stride=2)
    l2 = res_block(p.sub("res_block2"), l2, slope)
    l3 = conv(p.sub("conv3"), l2, stride=2)
    l3 = res_block(p.sub("res_block3"), l3, slope)
    return l1, l2, l3


def multi_scale_context_fusion(p, c1, c2, c3, slope=0.01):
    """Coarse-to-fine context fusion (`dmc_net.py:34-62`)."""
    c3_up = subpel_conv(p.sub("conv3_up"), c3, 2)
    c3_up = res_block(p.sub("res_block3_up"), c3_up, slope)
    c3_out = conv(p.sub("conv3_out"), c3)
    c3_out = res_block(p.sub("res_block3_out"), c3_out, slope)
    cat32 = cat([c3_up, c2])
    c2_up = subpel_conv(p.sub("conv2_up"), cat32, 2)
    c2_up = res_block(p.sub("res_block2_up"), c2_up, slope)
    c2_out = conv(p.sub("conv2_out"), cat32)
    c2_out = res_block(p.sub("res_block2_out"), c2_out, slope)
    if packed_width() == 2:
        def tail(xp):
            f = pconv(p.sub("conv1_out"), xp)
            return p_res_block(p.sub("res_block1_out"), f, slope)

        c1_out = packed_region(cat([c2_up, c1]), tail)
    else:
        c1_out = conv(p.sub("conv1_out"), cat([c2_up, c1]))
        c1_out = res_block(p.sub("res_block1_out"), c1_out, slope)
    return c1 + c1_out, c2 + c2_out, c3 + c3_out


# ---------------------------------------------------------------------------
# GDN residual autoencoders (`dmc_net.py:65-156`)

def gdn_res_encoder(p, x, c1, c2, c3):
    """Context-conditioned analysis: conv+GDN stages interleaved with
    bottleneck ResBlocks on concatenated multi-scale contexts."""
    f = conv(p.sub("conv1"), cat([x, c1]), stride=2)
    f = gdn_p(p.sub("gdn1"), f)
    f = res_block(p.sub("res1"), cat([f, c2]),
                  slope=0.1, start_from_relu=False, end_with_relu=True)
    f = conv(p.sub("conv2"), f, stride=2)
    f = gdn_p(p.sub("gdn2"), f)
    f = res_block(p.sub("res2"), cat([f, c3]),
                  slope=0.1, start_from_relu=False, end_with_relu=True)
    f = conv(p.sub("conv3"), f, stride=2)
    f = gdn_p(p.sub("gdn3"), f)
    return conv(p.sub("conv4"), f, stride=2)


def gdn_res_decoder(p, y, c2, c3):
    """Context-conditioned synthesis mirror of gdn_res_encoder."""
    f = subpel_conv(p.sub("up1"), y, 2)
    f = gdn_p(p.sub("gdn1"), f, inverse=True)
    f = subpel_conv(p.sub("up2"), f, 2)
    f = gdn_p(p.sub("gdn2"), f, inverse=True)
    f = res_block(p.sub("res1"), cat([f, c3]),
                  slope=0.1, start_from_relu=False, end_with_relu=True)
    f = subpel_conv(p.sub("up3"), f, 2)
    f = gdn_p(p.sub("gdn3"), f, inverse=True)
    f = res_block(p.sub("res2"), cat([f, c2]),
                  slope=0.1, start_from_relu=False, end_with_relu=True)
    return subpel_conv(p.sub("up4"), f, 2)


def recon_generation_simple(p, ctx, res):
    """conv + 2 ResBlocks + recon conv (`dmc_net.py:143-156`).
    Returns (feature, recon); width-packed under packed width 2."""
    if packed_width() == 2:
        fp = pconv(p.sub("feature_conv.0"), pack_width(cat([ctx, res]), 2))
        fp = p_res_block(p.sub("feature_conv.1"), fp)
        fp = p_res_block(p.sub("feature_conv.2"), fp)
        recon = unpack_width(pconv(p.sub("recon_conv"), fp), 2)
        return unpack_width(fp, 2), recon
    f = conv(p.sub("feature_conv.0"), cat([ctx, res]))
    f = res_block(p.sub("feature_conv.1"), f)
    f = res_block(p.sub("feature_conv.2"), f)
    recon = conv(p.sub("recon_conv"), f)
    return f, recon


def temporal_prior_encoder_gdn(p, c1, c2, c3):
    """Multi-scale temporal prior (`dmc_net.py:121-140`)."""
    f = conv(p.sub("conv1"), c1, stride=2)
    f = gdn_p(p.sub("gdn1"), f)
    f = conv(p.sub("conv2"), cat([f, c2]), stride=2)
    f = gdn_p(p.sub("gdn2"), f)
    f = conv(p.sub("conv3"), cat([f, c3]), stride=2)
    f = gdn_p(p.sub("gdn3"), f)
    return conv(p.sub("conv4"), f, stride=2)


# ---------------------------------------------------------------------------
# SpyNet motion estimation

def me_basic(p, x):
    """5-layer 7x7 CNN refinement (`video_net_component.py:191-210`).

    Under packed width 2 (and a width that divides by 4) it runs packed at
    p=4, as the JAX package does (7-wide taps pack to 3-wide)."""
    if packed_width() == 2 and x.shape[2] % 4 == 0:
        xp = pack_width(x.contiguous(), 4)
        for i in range(1, 5):
            xp = relu(pconv(p.sub(f"conv{i}"), xp, p=4))
        return unpack_width(pconv(p.sub("conv5"), xp, p=4), 4)
    x = relu(conv(p.sub("conv1"), x))
    x = relu(conv(p.sub("conv2"), x))
    x = relu(conv(p.sub("conv3"), x))
    x = relu(conv(p.sub("conv4"), x))
    return conv(p.sub("conv5"), x)


def me_spynet(p, im1, im2, levels: int = 4):
    """4-level coarse-to-fine SpyNet (`video_net_component.py:213-248`).

    im1/im2: NHWC RGB. Returns NHWC flow (dx, dy) at full resolution; one
    flow_warp launch per level."""
    im1_list = [im1]
    im2_list = [im2]
    for _ in range(levels - 1):
        im1_list.append(avg_pool2d(im1_list[-1], 2))
        im2_list.append(avg_pool2d(im2_list[-1], 2))

    # zeros at half the coarsest level, shaped by a pool of it
    flow = torch.zeros_like(avg_pool2d(im1_list[levels - 1][..., :2], 2))
    for level in range(levels):
        flow_up = bilinear_upsample2(flow) * 2.0
        i1 = im1_list[levels - 1 - level]
        i2 = im2_list[levels - 1 - level]
        inp = cat([i1, flow_warp(i2, flow_up), flow_up])
        flow = flow_up + me_basic(p.sub(f"moduleBasic.{level}"), inp)
    return flow


# ---------------------------------------------------------------------------
# Motion-compensated multi-scale warping (shared by DMC and LSSVC)

def scaled_flows(mv):
    """Flow pyramid: mv, mv/2 at half res, mv/4 at quarter res."""
    mv2 = bilinear_downsample2(mv) / 2
    mv3 = bilinear_downsample2(mv2) / 2
    return mv, mv2, mv3
