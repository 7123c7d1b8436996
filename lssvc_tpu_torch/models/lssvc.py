"""LSSVC — the two-layer P-frame codec (the JAX package's `models/lssvc.py`
`:121-309`, default unpacked branch).

Per two-layer P-frame:

  BL: DMC conditional coding (base_layer_model.*)
  inter-layer: MvResampler / TextureResampler / LayerPriorResampler lift the
    BL motion, texture and latent onto the EL grids
  EL motion: SpyNet flow coded conditionally on the upsampled BL motion
  EL context: motion-compensated temporal contexts (with OffsetDiversity
    alignment) blended with resampled BL texture via learned softmax maps
  EL residual: conditional AE whose entropy parameters fuse hyper, temporal
    and layer priors, quantized through the four-part checkerboard prior

Each frame launches flow_warp 14 times (4 SpyNet levels and 3 context warps
per layer) and grouped_warp once (OffsetDiversity).
"""

from __future__ import annotations

import torch

from ..convert import P
from ..entropy.models import factorized_bits, laplace_bits
from ..ops import (
    clamp_flow,
    flow_warp,
    flow_warp_pair,
    leaky_relu,
    pad_nhwc,
    ste_round,
)
from . import dmc
from .base import Model
from .components import (
    cat,
    conv,
    feature_extractor_3scale,
    gdn_p,
    me_spynet,
    multi_scale_context_fusion,
    scaled_flows,
    subpel_conv,
)
from .four_part_prior import forward_four_part_prior
from .lssvc_blocks import (
    el_recon_generation,
    el_res_decoder,
    el_res_encoder,
    hybrid_weight_generator,
    layer_prior_resampler,
    mv_context_transformer,
    mv_res_decoder,
    mv_res_encoder,
    mv_resampler,
    offset_diversity,
    prior_fusion,
    texture_resampler,
)


def mv_ctx_prior_encoder(p, mv_upsample):
    """4x stride-2 conv+GDN on the upsampled BL motion (`LSSVC_net.py:108-116`)."""
    f = conv(p.sub("0"), mv_upsample, stride=2)
    f = gdn_p(p.sub("1"), f)
    f = conv(p.sub("2"), f, stride=2)
    f = gdn_p(p.sub("3"), f)
    f = conv(p.sub("4"), f, stride=2)
    f = gdn_p(p.sub("5"), f)
    return conv(p.sub("6"), f, stride=2)


def mv_hyper_encoder(p, x):
    f = leaky_relu(conv(p.sub("0"), x), 0.01)
    f = leaky_relu(conv(p.sub("2"), f, stride=2), 0.01)
    return conv(p.sub("4"), f, stride=2)


def mv_hyper_decoder(p, z_hat):
    f = leaky_relu(subpel_conv(p.sub("0"), z_hat, 2), 0.01)
    f = leaky_relu(subpel_conv(p.sub("2"), f, 2), 0.01)
    return conv(p.sub("4"), f)


def mv_prior_fusion(p, x):
    f = leaky_relu(conv(p.sub("0"), x), 0.01)
    f = leaky_relu(conv(p.sub("2"), f), 0.01)
    return conv(p.sub("4"), f)


def res_prior_encoder(p, y):
    f = leaky_relu(conv(p.sub("0"), y), 0.01)
    f = leaky_relu(conv(p.sub("2"), f, stride=2), 0.01)
    return conv(p.sub("4"), f, stride=2)


def res_prior_decoder(p, z_hat):
    f = leaky_relu(conv(p.sub("0"), z_hat), 0.01)
    f = leaky_relu(subpel_conv(p.sub("2"), f, 2), 0.01)
    f = leaky_relu(conv(p.sub("4"), f), 0.01)
    f = leaky_relu(subpel_conv(p.sub("6"), f, 2), 0.01)
    return conv(p.sub("8"), f)


def temporal_prior_encoder(p, c3):
    f = conv(p.sub("0"), c3, stride=2)
    f = leaky_relu(f, 0.1)
    return conv(p.sub("2"), f, stride=2)


def el_feature_adaptor(p, ref_el, feature_el):
    """Dispatch on DPB feature provenance (`LSSVC_net.py:195-202`)."""
    if feature_el is None:
        return conv(p.sub("feature_adaptor_EL_I"), ref_el)
    if feature_el.shape[-1] == 64:
        return conv(p.sub("feature_adaptor_EL_first_P"), feature_el)
    return conv(p.sub("feature_adaptor_EL"), feature_el)


def el_motion_compensation(p, ref_el, feature_el, mv, od_offset_cap=None):
    """Warp EL features at 3 scales with OffsetDiversity refinement at full
    resolution (`LSSVC_net.py:229-244`)."""
    mv = clamp_flow(mv, ref_el.shape[1], ref_el.shape[2])  # exact; see clamp_flow
    mv1, mv2, mv3 = scaled_flows(mv)
    f = el_feature_adaptor(p, ref_el, feature_el)
    f1, f2, f3 = feature_extractor_3scale(p.sub("feature_extractor"), f)
    warpframe, c1_init = flow_warp_pair(ref_el, f1, mv1)
    c1 = offset_diversity(p.sub("align"), f1,
                          cat([c1_init, warpframe, mv]), mv,
                          offset_cap=od_offset_cap)
    c2 = flow_warp(f2, mv2)
    c3 = flow_warp(f3, mv3)
    c1, c2, c3 = multi_scale_context_fusion(p.sub("context_fusion_net"),
                                            c1, c2, c3)
    return (c1, c2, c3), warpframe


def hybrid_context_fusion(p, texture_bl, mv, ref_el, feature_el, shape_hr,
                          od_offset_cap=None):
    """Blend temporal and spatial (BL-texture) contexts (`LSSVC_net.py:246-259`)."""
    temporal_ctx, warp_frame = el_motion_compensation(
        p, ref_el, feature_el, mv, od_offset_cap)
    if texture_bl is not None:
        texture = texture_resampler(p.sub("texture_resampler"), texture_bl,
                                    shape_hr)
        spatial_ctx = feature_extractor_3scale(p.sub("texture_extractor"),
                                               texture)
        map_t, map_s = hybrid_weight_generator(p.sub("weight_map_generator"),
                                               temporal_ctx, spatial_ctx)
        c1 = temporal_ctx[0] * map_t[0] + spatial_ctx[0] * map_s[0]
        c2 = temporal_ctx[1] * map_t[1] + spatial_ctx[1] * map_s[1]
        c3 = temporal_ctx[2] * map_t[2] + spatial_ctx[2] * map_s[2]
    else:
        c1, c2, c3 = temporal_ctx
    c1, c2, c3 = multi_scale_context_fusion(p.sub("context_fusion_net"),
                                            c1, c2, c3)
    return c1, c2, c3, warp_frame


def el_motion_coding(p, x_el, ref_el, mv_bl_hat, shape_hr, scale_factor):
    """BL-conditioned EL motion estimation + coding."""
    mv_upsample = mv_resampler(p.sub("mv_resampler"), mv_bl_hat, shape_hr,
                               scale_factor)
    mv_ctx_prior = mv_ctx_prior_encoder(p.sub("mv_ctx_prior_encoder"),
                                        mv_upsample)
    mv_ctx = mv_context_transformer(p.sub("mv_ctx_transform"), mv_upsample)

    mv = me_spynet(p.sub("optic_flow"), x_el, ref_el)
    mv_y = mv_res_encoder(p.sub("mv_encoder"), mv, mv_ctx)
    mv_z = mv_hyper_encoder(p.sub("mv_prior_encoder"), mv_y)
    mv_z_hat = ste_round(mv_z)
    mv_hyper_prior = mv_hyper_decoder(p.sub("mv_prior_decoder"), mv_z_hat)
    mv_params = mv_prior_fusion(p.sub("mv_prior_fusion"),
                                cat([mv_hyper_prior, mv_ctx_prior]))
    half = mv_params.shape[-1] // 2
    mv_scales_hat = mv_params[..., :half]
    mv_means_hat = mv_params[..., half:]
    mv_y_q = ste_round(mv_y - mv_means_hat)
    mv_y_hat = mv_y_q + mv_means_hat
    mv_hat = mv_res_decoder(p.sub("mv_decoder"), mv_y_hat, mv_ctx)
    return {
        "mv_hat": mv_hat,
        "mv_y_q": mv_y_q,
        "mv_z_hat": mv_z_hat,
        "mv_scales_hat": mv_scales_hat,
    }


def el_forward(params, x_el, ref_el, feature_el, texture_bl, mv_bl_hat,
               y_bl_hat, shape_hr, scale_factor, od_offset_cap=None):
    """Full EL P-frame forward (estimated bits)."""
    p = P(params)
    mc = el_motion_coding(p, x_el, ref_el, mv_bl_hat, shape_hr, scale_factor)
    c1, c2, c3, warp_frame = hybrid_context_fusion(
        p, texture_bl, mc["mv_hat"], ref_el, feature_el, shape_hr,
        od_offset_cap)

    y = el_res_encoder(p.sub("res_encoder"), x_el, c1, c2, c3)
    z = res_prior_encoder(p.sub("res_prior_encoder"), y)
    z_hat = ste_round(z)
    hierarchical = res_prior_decoder(p.sub("res_prior_decoder"), z_hat)
    temporal = temporal_prior_encoder(p.sub("temporal_prior_encoder"), c3)
    layer_prior = layer_prior_resampler(
        p.sub("layer_prior_resampler"), y_bl_hat,
        (shape_hr[0] // 16, shape_hr[1] // 16))
    common_params = prior_fusion(p.sub("prior_fusion_net"), hierarchical,
                                 temporal, layer_prior)

    _, y_q, y_hat, scales_hat = forward_four_part_prior(p, y, common_params)

    recon_feature = el_res_decoder(p.sub("res_decoder"), y_hat, c2, c3)
    feature, recon_el = el_recon_generation(p.sub("recon_generation_net"),
                                            recon_feature, c1)

    bits_y, _ = laplace_bits(y_q, scales_hat)
    bits_mv_y, _ = laplace_bits(mc["mv_y_q"], mc["mv_scales_hat"])
    bits_z, _ = factorized_bits(p.sub("bit_estimator_z"), z_hat)
    bits_mv_z, _ = factorized_bits(p.sub("bit_estimator_z_mv"),
                                   mc["mv_z_hat"])
    bits_el = bits_y + bits_mv_y + bits_z + bits_mv_z

    return {
        "recon_el": recon_el,
        "feature_el": feature,
        "bits_el": bits_el,
        "mv_hat": mc["mv_hat"],
        "warp_frame": warp_frame,
        "context": c1,
    }


def forward_one_frame(params, x_bl, x_el, ref_frame_bl, ref_frame_el,
                      ref_feature_bl, ref_feature_el, shape_hr, scale_factor,
                      pad_size, od_offset_cap=None):
    """Two-layer P-frame forward (`LSSVC_net.py:445-528`)."""
    bl_params = {k[len("base_layer_model."):]: v for k, v in params.items()
                 if k.startswith("base_layer_model.")}
    bl = dmc.forward_inter(bl_params, x_bl, ref_frame_bl, ref_feature_bl)

    texture = pad_nhwc(bl["feature"], pad_size)
    mv_bl_hat = pad_nhwc(bl["mv_hat"], pad_size)
    y_bl_hat = pad_nhwc(bl["y_hat"], tuple(int(v / 16) for v in pad_size))

    el = el_forward(params, x_el, ref_frame_el, ref_feature_el, texture,
                    mv_bl_hat, y_bl_hat, shape_hr, scale_factor,
                    od_offset_cap)

    return {
        "dpb": {
            "ref_frame_bl": bl["recon_image"],
            "ref_feature_bl": bl["feature"],
            "ref_frame_el": el["recon_el"],
            "ref_feature_el": el["feature_el"],
        },
        "bit_bl": bl["bits"],
        "bit_el": el["bits_el"],
        "mv_hat": el["mv_hat"],
        "warp_frame": el["warp_frame"],
        "warp_frame_bl": bl["warp_frame"],
        "context": el["context"],
    }


class LSSVC(Model):
    """Two-layer P-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for).

    `od_offset_cap` clips OffsetDiversity's diversity offsets (px): None
    leaves them uncapped, `ops.nn.OD_OFFSET_CAP_SERVING` is the serving
    preset."""

    def __init__(self, params: dict, device="cuda", od_offset_cap=None):
        super().__init__(params, device=device)
        self.od_offset_cap = od_offset_cap
        self.shape_hr = (256, 256)
        self.scale_factor = 2.0
        self.pad_size = (0, 0, 0, 0)

    def set_scale_information(self, scale, shape_hr, pad_size):
        self.scale_factor = float(scale)
        self.shape_hr = tuple(int(v) for v in shape_hr)
        self.pad_size = tuple(int(v) for v in pad_size)

    @torch.no_grad()
    def forward_one_frame(self, x_bl, x_el, ref_frame_bl, ref_frame_el,
                          ref_feature_bl, ref_feature_el):
        return forward_one_frame(self.flat_params(), x_bl, x_el, ref_frame_bl,
                                 ref_frame_el, ref_feature_bl, ref_feature_el,
                                 self.shape_hr, self.scale_factor,
                                 self.pad_size, self.od_offset_cap)
