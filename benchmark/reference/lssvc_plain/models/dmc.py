"""DMC — conditional-coding P-frame codec for the base layer (DCVC-TCM style).

The JAX package's `models/dmc.py` `forward_inter` and `motion_compensation`
(`:89-183`).  Per frame: SpyNet motion estimation -> MV autoencoder with
hyperprior -> multi-scale motion-compensated context -> conditional
residual autoencoder whose entropy parameters fuse a temporal prior with
the hyperprior.  Bits are estimated, not coded.
"""

from __future__ import annotations

from ..convert import P
from ..entropy.models import factorized_bits, laplace_bits
from ..ops import clamp_flow, flow_warp, flow_warp_pair, leaky_relu, ste_round
from ..ops.nn import compute_dtype
from .base import Model, scoped
from .components import (
    cat,
    conv,
    deconv,
    feature_extractor_3scale,
    gdn_p,
    gdn_res_decoder,
    gdn_res_encoder,
    me_spynet,
    multi_scale_context_fusion,
    recon_generation_simple,
    res_block,
    scaled_flows,
    temporal_prior_encoder_gdn,
)


def mv_encoder(p, mv):
    """3x (stride-2 conv, GDN, ResBlock, leaky) + stride-2 conv
    (`dmc_net.py:174-188`)."""
    x = mv
    for base in (0, 4, 8):
        x = conv(p.sub(str(base)), x, stride=2)
        x = gdn_p(p.sub(str(base + 1)), x)
        x = res_block(p.sub(str(base + 2)), x, start_from_relu=False)
        x = leaky_relu(x, 0.1)
    return conv(p.sub("12"), x, stride=2)


def hyper_encoder(p, x):
    """conv / conv s2 / conv s2 (`dmc_net.py:190-196,230-236`)."""
    x = leaky_relu(conv(p.sub("0"), x), 0.01)
    x = leaky_relu(conv(p.sub("2"), x, stride=2), 0.01)
    return conv(p.sub("4"), x, stride=2)


def hyper_decoder(p, z_hat):
    """deconv s2 / deconv s2 / deconv s1 (`dmc_net.py:198-206,238-246`)."""
    x = leaky_relu(deconv(p.sub("0"), z_hat), 0.01)
    x = leaky_relu(deconv(p.sub("2"), x), 0.01)
    return deconv(p.sub("4"), x, stride=1, padding=1, output_padding=0)


def mv_decoder(p, mv_y_hat):
    """deconv/ResBlock/IGDN pyramid back to a 2-ch flow (`dmc_net.py:208-221`)."""
    x = deconv(p.sub("0"), mv_y_hat)
    x = leaky_relu(x, 0.1)
    x = res_block(p.sub("2"), x, start_from_relu=False)
    x = gdn_p(p.sub("3"), x, inverse=True)
    x = deconv(p.sub("4"), x)
    x = gdn_p(p.sub("5"), x, inverse=True)
    x = deconv(p.sub("6"), x)
    x = gdn_p(p.sub("7"), x, inverse=True)
    return deconv(p.sub("8"), x)


def entropy_parameters(p, x):
    x = leaky_relu(conv(p.sub("0"), x), 0.01)
    x = leaky_relu(conv(p.sub("2"), x), 0.01)
    return conv(p.sub("4"), x)


def motion_compensation(p, ref, feature, mv):
    """Warp multi-scale reference features and fuse (`dmc_net.py:352-368`).

    Three flow_warp launches: the reference frame and f1 share mv and warp
    as one pair, then f2 and f3 by the scaled flows."""
    mv = clamp_flow(mv, ref.shape[1], ref.shape[2])  # exact; see clamp_flow
    mv1, mv2, mv3 = scaled_flows(mv)
    if feature is None:
        f = conv(p.sub("feature_adaptor_I"), ref)
    else:
        f = conv(p.sub("feature_adaptor_P"), feature)
    f1, f2, f3 = feature_extractor_3scale(p.sub("feature_extractor"), f)
    # the reference frame joins f1's compute dtype (`dmc.py:103-112`)
    warpframe, c1 = flow_warp_pair(ref.to(compute_dtype()).to(f1.dtype), f1,
                                   mv1)
    c2 = flow_warp(f2, mv2)
    c3 = flow_warp(f3, mv3)
    c1, c2, c3 = multi_scale_context_fusion(p.sub("context_fusion_net"),
                                            c1, c2, c3)
    return c1, c2, c3, warpframe


def forward_inter(params, x, ref_frame, ref_feature):
    """Eval P-frame forward with estimated bits (`dmc_net.py:421-488`).

    ref_feature may be None (I-frame reference)."""
    p = P(params)
    est_mv = me_spynet(p.sub("optic_flow"), x, ref_frame)
    mv_y = mv_encoder(p.sub("mv_encoder"), est_mv)
    mv_z = hyper_encoder(p.sub("mv_prior_encoder"), mv_y)
    mv_z_hat = ste_round(mv_z)
    mv_params = hyper_decoder(p.sub("mv_prior_decoder"), mv_z_hat)
    half = mv_params.shape[-1] // 2
    mv_scales_hat = mv_params[..., :half]
    mv_means_hat = mv_params[..., half:]
    mv_y_q = ste_round(mv_y - mv_means_hat)
    mv_y_hat = mv_y_q + mv_means_hat
    mv_hat = mv_decoder(p.sub("mv_decoder"), mv_y_hat)

    c1, c2, c3, warpframe = motion_compensation(p, ref_frame, ref_feature,
                                                mv_hat)

    y = gdn_res_encoder(p.sub("res_encoder"), x, c1, c2, c3)
    z = hyper_encoder(p.sub("res_prior_encoder"), y)
    z_hat = ste_round(z)
    hierarchical = hyper_decoder(p.sub("res_prior_decoder"), z_hat)
    temporal = temporal_prior_encoder_gdn(p.sub("temporal_prior_encoder"),
                                          c1, c2, c3)
    gaussian_params = entropy_parameters(p.sub("res_entropy_parameter"),
                                         cat([temporal, hierarchical]))
    half = gaussian_params.shape[-1] // 2
    scales_hat = gaussian_params[..., :half]
    means_hat = gaussian_params[..., half:]
    y_q = ste_round(y - means_hat)
    y_hat = y_q + means_hat

    recon_feature = gdn_res_decoder(p.sub("res_decoder"), y_hat, c2, c3)
    feature, recon_image = recon_generation_simple(
        p.sub("recon_generation_net"), recon_feature, c1)

    bits_y, _ = laplace_bits(y_q, scales_hat)
    bits_mv_y, _ = laplace_bits(mv_y_q, mv_scales_hat)
    bits_z, _ = factorized_bits(p.sub("bit_estimator_z"), z_hat)
    bits_mv_z, _ = factorized_bits(p.sub("bit_estimator_z_mv"), mv_z_hat)
    total_bits = bits_y + bits_z + bits_mv_y + bits_mv_z

    pixel_num = x.shape[0] * x.shape[1] * x.shape[2]
    return {
        "bpp": total_bits / pixel_num,
        "bits": total_bits,
        "recon_image": recon_image,
        "feature": feature,
        "y_hat": y_hat,
        "mv_hat": mv_hat,
        "warp_frame": warpframe,
    }


class DMC(Model):
    """Base-layer P-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for), in the mode of `models/base.py`."""

    @scoped
    def forward_inter(self, x, ref_frame, ref_feature):
        return forward_inter(self.flat_params(), x, ref_frame, ref_feature)
