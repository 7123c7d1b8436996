"""LSSVC — the two-layer P-frame codec (the JAX package's `models/lssvc.py`
`:121-309`), in every mode of `ops.nn.Mode`: the precisions, the
width-packed domain and its fused packed pair warp.

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
per layer) and grouped_warp once (OffsetDiversity); with the fused packed
pair warp, the EL pair's launch is the packed store.
"""

from __future__ import annotations

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
from ..ops.nn import compute_dtype, current_mode, packed_width
from ..ops.packed import pack_width, unpack_width
from . import dmc
from .base import Model, scoped
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
from .packed_blocks import packed_region, pconv
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

BL_PREFIX = "base_layer_model."


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
    """Dispatch on DPB feature provenance (`LSSVC_net.py:195-202`); the
    steady-state (48-channel full-res) adaptor runs width-packed under
    packed width 2."""
    if feature_el is None:
        return conv(p.sub("feature_adaptor_EL_I"), ref_el)
    if feature_el.shape[-1] == 64:
        return conv(p.sub("feature_adaptor_EL_first_P"), feature_el)
    if packed_width() == 2:
        return packed_region(
            feature_el, lambda xp: pconv(p.sub("feature_adaptor_EL"), xp))
    return conv(p.sub("feature_adaptor_EL"), feature_el)


def el_motion_compensation(p, ref_el, feature_el, mv, od_offset_cap=None):
    """Warp EL features at 3 scales with OffsetDiversity refinement at full
    resolution (`LSSVC_net.py:229-244`)."""
    mv = clamp_flow(mv, ref_el.shape[1], ref_el.shape[2])  # exact; see clamp_flow
    mv1, mv2, mv3 = scaled_flows(mv)
    f = el_feature_adaptor(p, ref_el, feature_el)
    f1, f2, f3 = feature_extractor_3scale(p.sub("feature_extractor"), f)
    # the reference frame joins f1's compute dtype, so a bf16 f1 keeps the
    # pair on the warp's bf16 path (`lssvc.py:150-155`)
    ref = ref_el.to(compute_dtype()).to(f1.dtype)
    if (current_mode().packed_ctx and packed_width() == 2
            and ref_el.shape[2] % 4 == 0):
        # the fused packed pair warp (`lssvc.py:159-178`): one launch
        # stores [ref_el, f1] warped into one (N, H, W/2, 2*51) buffer,
        # which OffsetDiversity's entry conv reads through its kernel's
        # input permutation; warpframe is a strided view of it
        pair = flow_warp_pair(ref, f1, mv1, packed_out=True)
        warpframe = unpack_width(pair, 2)[..., :ref.shape[-1]]
        c1 = offset_diversity(p.sub("align"), f1, None, mv,
                              offset_cap=od_offset_cap,
                              aux_pair_packed=pair,
                              mv_packed=pack_width(mv, 2))
    else:
        warpframe, c1_init = flow_warp_pair(ref, f1, mv1)
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


# --- the EL P-frame, in the JAX package's three EL stages (`lssvc.py:319-363`,
# which run each as its own XLA program so that a batch of 1080p sequences
# fits a 16 GB chip).  In eager PyTorch a stage boundary is no boundary at
# all, so the fused and the staged frames are these same calls.

def _el_stage_ctx(params, x_el, ref_el, feature_el, texture_bl, mv_bl_hat,
                  shape_hr, scale_factor, od_offset_cap=None):
    """EL motion coding and hybrid context fusion (the stage that holds the
    warps, OffsetDiversity and the feature pyramids)."""
    p = P(params)
    mc = el_motion_coding(p, x_el, ref_el, mv_bl_hat, shape_hr, scale_factor)
    c1, c2, c3, warp_frame = hybrid_context_fusion(
        p, texture_bl, mc["mv_hat"], ref_el, feature_el, shape_hr,
        od_offset_cap)
    bits_mv_y, _ = laplace_bits(mc["mv_y_q"], mc["mv_scales_hat"])
    bits_mv_z, _ = factorized_bits(p.sub("bit_estimator_z_mv"), mc["mv_z_hat"])
    return c1, c2, c3, warp_frame, mc["mv_hat"], bits_mv_y + bits_mv_z


def _el_stage_res(params, x_el, c1, c2, c3, y_bl_hat, shape_hr):
    """Residual AE, priors and the four-part prior: y_hat and the residual
    bits."""
    p = P(params)
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
    bits_y, _ = laplace_bits(y_q, scales_hat)
    bits_z, _ = factorized_bits(p.sub("bit_estimator_z"), z_hat)
    return y_hat, bits_y + bits_z


def _el_stage_recon(params, y_hat, c1, c2, c3):
    """The residual decoder and the recon generation: (recon, feature)."""
    p = P(params)
    recon_feature = el_res_decoder(p.sub("res_decoder"), y_hat, c2, c3)
    feature, recon_el = el_recon_generation(p.sub("recon_generation_net"),
                                            recon_feature, c1)
    return recon_el, feature


def el_forward(params, x_el, ref_el, feature_el, texture_bl, mv_bl_hat,
               y_bl_hat, shape_hr, scale_factor, od_offset_cap=None):
    """Full EL P-frame forward (estimated bits): the three EL stages."""
    c1, c2, c3, warp_frame, mv_hat, bits_mv = _el_stage_ctx(
        params, x_el, ref_el, feature_el, texture_bl, mv_bl_hat, shape_hr,
        scale_factor, od_offset_cap)
    y_hat, bits_res = _el_stage_res(params, x_el, c1, c2, c3, y_bl_hat,
                                    shape_hr)
    recon_el, feature = _el_stage_recon(params, y_hat, c1, c2, c3)
    return {
        "recon_el": recon_el,
        "feature_el": feature,
        "bits_el": bits_mv + bits_res,
        "mv_hat": mv_hat,
        "warp_frame": warp_frame,
        "context": c1,
    }


def _bl_stage(params, x_bl, ref_frame_bl, ref_feature_bl, pad_size):
    """The BL frame, and its texture, motion and latent padded onto the EL
    grids."""
    bl_params = {k[len(BL_PREFIX):]: v for k, v in params.items()
                 if k.startswith(BL_PREFIX)}
    bl = dmc.forward_inter(bl_params, x_bl, ref_frame_bl, ref_feature_bl)
    texture = pad_nhwc(bl["feature"], pad_size)
    mv_bl_hat = pad_nhwc(bl["mv_hat"], pad_size)
    y_bl_hat = pad_nhwc(bl["y_hat"], tuple(int(v / 16) for v in pad_size))
    return bl, texture, mv_bl_hat, y_bl_hat


def forward_one_frame(params, x_bl, x_el, ref_frame_bl, ref_frame_el,
                      ref_feature_bl, ref_feature_el, shape_hr, scale_factor,
                      pad_size, od_offset_cap=None):
    """Two-layer P-frame forward (`LSSVC_net.py:445-528`)."""
    bl, texture, mv_bl_hat, y_bl_hat = _bl_stage(
        params, x_bl, ref_frame_bl, ref_feature_bl, pad_size)
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


def forward_one_frame_staged3(*args, **kwargs):
    """The four-stage P-frame of the JAX package (`lssvc.py:364-400`: BL |
    EL contexts | EL residual | EL recon) with its keys: here the fused
    frame, whose EL already runs the three stages, less `warp_frame_bl`."""
    out = forward_one_frame(*args, **kwargs)
    del out["warp_frame_bl"]
    return out


# the two-stage frame (`lssvc.py:403-436`: BL | EL) is the same frame here
forward_one_frame_staged = forward_one_frame_staged3


class LSSVC(Model):
    """Two-layer P-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for).  The `base_layer_model.` keys form
    the submodule `base_layer_model`, a `BASE_LAYER` (DMC), so
    `state_dict()` has the reference's keys.

    `od_offset_cap` clips OffsetDiversity's diversity offsets (px): None
    leaves them uncapped, `ops.nn.OD_OFFSET_CAP_SERVING` is the serving
    preset.  `precision`, `packed_width`, `conv1x1_einsum` and `packed_ctx`
    are the model's mode (`models/base.py`); the base layer is built in the
    same mode."""

    BASE_LAYER = dmc.DMC

    def __init__(self, params: dict, device="cuda", od_offset_cap=None,
                 precision="fp32", packed_width=1, conv1x1_einsum=False,
                 packed_ctx=False):
        mode = dict(precision=precision, packed_width=packed_width,
                    conv1x1_einsum=conv1x1_einsum)
        super().__init__({k: v for k, v in params.items()
                          if not k.startswith(BL_PREFIX)}, device=device,
                         packed_ctx=packed_ctx, **mode)
        self.base_layer_model = self.BASE_LAYER(
            {k[len(BL_PREFIX):]: v for k, v in params.items()
             if k.startswith(BL_PREFIX)}, device=device, **mode)
        self.od_offset_cap = od_offset_cap
        self.shape_hr = (256, 256)
        self.scale_factor = 2.0
        self.pad_size = (0, 0, 0, 0)

    def set_scale_information(self, scale, shape_hr, pad_size):
        self.scale_factor = float(scale)
        self.shape_hr = tuple(int(v) for v in shape_hr)
        self.pad_size = tuple(int(v) for v in pad_size)

    @scoped
    def forward_one_frame(self, x_bl, x_el, ref_frame_bl, ref_frame_el,
                          ref_feature_bl, ref_feature_el):
        return forward_one_frame(self.flat_params(), x_bl, x_el, ref_frame_bl,
                                 ref_frame_el, ref_feature_bl, ref_feature_el,
                                 self.shape_hr, self.scale_factor,
                                 self.pad_size, self.od_offset_cap)

    @scoped
    def forward_one_frame_staged3(self, x_bl, x_el, ref_frame_bl,
                                  ref_frame_el, ref_feature_bl,
                                  ref_feature_el):
        return forward_one_frame_staged3(
            self.flat_params(), x_bl, x_el, ref_frame_bl, ref_frame_el,
            ref_feature_bl, ref_feature_el, self.shape_hr, self.scale_factor,
            self.pad_size, self.od_offset_cap)

    forward_one_frame_staged = forward_one_frame_staged3
