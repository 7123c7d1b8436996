"""LSSVCExtend: real bitstreams of the two-layer P-frame (the JAX package's
`models/lssvc.py:508-587` and `models/lssvc_stream.py`; reference
`LSSVC_net_extend.py:24-263`).

Per P-frame, two .bin files: the BL's (`dmc_stream.DMCExtend`), then the
EL's, one buffered rANS stream in the order mv_z, mv_y, z, then the four
checkerboard passes of y.  The EL decoder runs in stages split at the
entropy decodes; the four-part prior alternates a device pass (the next
pass's scale planes) and a host rANS decode.

The encoder is closed-loop, as the BL's (`dmc_stream.py`): every
scale-index and means plane, the four passes' included, comes from the
decoder's own stage functions on int-normalised symbol planes; only the
analysis fronts (EL SpyNet + mv AE, the residual AE) are the encoder's.
"""

from __future__ import annotations

import time

import torch

from ..convert import P
from ..entropy.coder import VideoCoder
from ..entropy.models import build_indexes_video
from ..ops import pad_nhwc
from ..utils.checks import finite_flags, raise_if_nonfinite, sanitize_dpb
from ..utils.stream import decode_p, encode_p, filesize, \
    get_downsampled_shape
from .components import cat, me_spynet
from .dmc_stream import DecodeProfilingMixin, DMCExtend, _sync, quantize_i
from .four_part_prior import PASS_MASKS, checkerboard_masks, \
    spatial_prior_net
from .base import scoped
from .lssvc import (
    LSSVC,
    el_recon_generation,
    el_res_decoder,
    el_res_encoder,
    hybrid_context_fusion,
    mv_context_transformer,
    mv_ctx_prior_encoder,
    mv_hyper_decoder,
    mv_hyper_encoder,
    mv_prior_fusion,
    mv_res_decoder,
    mv_res_encoder,
    res_prior_decoder,
    res_prior_encoder,
    temporal_prior_encoder,
)
from .lssvc_blocks import layer_prior_resampler, mv_resampler, prior_fusion

# channels of the EL's residual hyper-latent z (its mv_z has channel_mv)
EL_Z_CHANNELS = 128


def _depad(dpb, pad_size):
    texture = pad_nhwc(dpb["texture"], pad_size)
    mv_bl_hat = pad_nhwc(dpb["mv_hat_bl"], pad_size)
    y_bl_hat = pad_nhwc(dpb["y_hat_bl"], tuple(int(v / 16) for v in pad_size))
    return texture, mv_bl_hat, y_bl_hat


def _masked_sum(planes_4, masks, pass_idx):
    """Each channel quarter on its mask of pass `pass_idx`, summed into one
    (1, h, w, C/4) plane (the masks are disjoint)."""
    return sum(planes_4[q] * masks[m]
               for q, m in enumerate(PASS_MASKS[pass_idx]))


# --- the encoder's analysis fronts ------------------------------------------

def enc_mv_analysis(p, x_el, ref_el, mv_ctx):
    """EL SpyNet -> context-conditioned mv AE -> hyper AE.  mv_ctx comes
    from the decoder's `dec_mv_setup`."""
    mv = me_spynet(p.sub("optic_flow"), x_el, ref_el)
    mv_y = mv_res_encoder(p.sub("mv_encoder"), mv, mv_ctx)
    mv_z = mv_hyper_encoder(p.sub("mv_prior_encoder"), mv_y)
    return mv_y, mv_z


def enc_res_analysis(p, x_el, c1, c2, c3):
    y = el_res_encoder(p.sub("res_encoder"), x_el, c1, c2, c3)
    z = res_prior_encoder(p.sub("res_prior_encoder"), y)
    return y, z


def enc_pass_symbols(pass_idx, y, means_4):
    """Symbol plane of one four-part-prior pass: each channel quarter's
    round(y - means) on its mask, summed (`LSSVC_net.py:338-443` write
    path); the means come from the decoder's `dec_pass_update` chain."""
    masks = checkerboard_masks(y.shape[1], y.shape[2], y.device)
    y_4 = torch.chunk(y, 4, dim=-1)
    # f32, as every symbol plane (`dmc_stream.quantize_i`)
    return sum(torch.round((y_4[q].float() - means_4[q].float()) * masks[m])
               for q, m in enumerate(PASS_MASKS[pass_idx])).to(torch.int32)


# --- the decoder's stages ---------------------------------------------------

def dec_mv_setup(p, mv_bl_hat, shape_hr, scale_factor):
    mv_upsample = mv_resampler(p.sub("mv_resampler"), mv_bl_hat, shape_hr,
                               scale_factor)
    mv_ctx_prior = mv_ctx_prior_encoder(p.sub("mv_ctx_prior_encoder"),
                                        mv_upsample)
    mv_ctx = mv_context_transformer(p.sub("mv_ctx_transform"), mv_upsample)
    return mv_ctx, mv_ctx_prior


def dec_mv_prior(p, mv_z_hat, mv_ctx_prior):
    hyper = mv_hyper_decoder(p.sub("mv_prior_decoder"), mv_z_hat)
    mv_params = mv_prior_fusion(p.sub("mv_prior_fusion"),
                                cat([hyper, mv_ctx_prior]))
    half = mv_params.shape[-1] // 2
    return build_indexes_video(mv_params[..., :half]), mv_params[..., half:]


def dec_contexts(p, mv_y_q, mv_means, mv_ctx, texture, ref_el, feature_el,
                 shape_hr, od_offset_cap):
    mv_hat = mv_res_decoder(p.sub("mv_decoder"), mv_y_q + mv_means, mv_ctx)
    c1, c2, c3, warp_frame = hybrid_context_fusion(
        p, texture, mv_hat, ref_el, feature_el, shape_hr, od_offset_cap)
    return mv_hat, c1, c2, c3, warp_frame


def dec_common_params(p, z_hat, c3, y_bl_hat, shape_hr):
    hierarchical = res_prior_decoder(p.sub("res_prior_decoder"), z_hat)
    temporal = temporal_prior_encoder(p.sub("temporal_prior_encoder"), c3)
    layer_prior = layer_prior_resampler(
        p.sub("layer_prior_resampler"), y_bl_hat,
        (shape_hr[0] // 16, shape_hr[1] // 16))
    return prior_fusion(p.sub("prior_fusion_net"), hierarchical, temporal,
                        layer_prior)


def dec_pass0(common_params):
    """Pass 0's scale-index plane and the four quarters' means, from the
    common parameters."""
    half = common_params.shape[-1] // 2
    scales_4 = torch.chunk(common_params[..., :half], 4, dim=-1)
    masks = checkerboard_masks(common_params.shape[1],
                               common_params.shape[2], common_params.device)
    return (build_indexes_video(_masked_sum(scales_4, masks, 0)),
            torch.chunk(common_params[..., half:], 4, dim=-1))


def dec_pass_update(p, pass_idx, y_q_r, y_hat, common_params, means_4):
    """Fold pass `pass_idx`'s decoded plane into y_hat; then, before the
    last pass, the next pass's scale indexes and means."""
    masks = checkerboard_masks(y_q_r.shape[1], y_q_r.shape[2], y_q_r.device)
    step = cat([(y_q_r + means_4[q]) * masks[m]
                for q, m in enumerate(PASS_MASKS[pass_idx])])
    y_hat = step if y_hat is None else y_hat + step
    if pass_idx == 3:
        return y_hat, None, None
    nxt = pass_idx + 1
    parts = torch.chunk(spatial_prior_net(
        p, p.sub(f"y_spatial_prior_adaptor_{nxt}"),
        cat([y_hat, common_params])), 8, dim=-1)
    return (y_hat, build_indexes_video(_masked_sum(parts[:4], masks, nxt)),
            parts[4:])


def dec_recon(p, y_hat, c1, c2, c3):
    recon_feature = el_res_decoder(p.sub("res_decoder"), y_hat, c2, c3)
    feature, recon = el_recon_generation(p.sub("recon_generation_net"),
                                         recon_feature, c1)
    return recon, feature


def encode_device(params, x_el, ref_el, feature_el, texture, mv_bl_hat,
                  y_bl_hat, shape_hr, scale_factor, od_offset_cap):
    """All device work of one EL frame, closed loop.  Returns (planes,
    dpb) on the device; the DPB is the decoder's, bit for bit."""
    p = P(params)
    mv_ctx, mv_ctx_prior = dec_mv_setup(p, mv_bl_hat, shape_hr, scale_factor)
    mv_y, mv_z = enc_mv_analysis(p, x_el, ref_el, mv_ctx)
    mv_z_i = torch.round(mv_z.float()).to(torch.int32)
    mv_idx, mv_means = dec_mv_prior(p, mv_z_i.float(), mv_ctx_prior)
    mv_y_q_i = quantize_i(mv_y, mv_means)
    mv_hat, c1, c2, c3, warp_frame = dec_contexts(
        p, mv_y_q_i.float(), mv_means, mv_ctx, texture, ref_el, feature_el,
        shape_hr, od_offset_cap)
    y, z = enc_res_analysis(p, x_el, c1, c2, c3)
    z_i = torch.round(z.float()).to(torch.int32)
    common = dec_common_params(p, z_i.float(), c3, y_bl_hat, shape_hr)
    # read on the host in write_planes, after the four passes are queued
    finite = finite_flags(mv_y=mv_y, mv_z=mv_z, mv_means=mv_means, y=y,
                          z=z, common_params=common)
    idx, means_4 = dec_pass0(common)
    y_syms, y_idxs, y_hat = [], [], None
    for pass_idx in range(4):
        sym_i = enc_pass_symbols(pass_idx, y, means_4)
        y_syms.append(sym_i)
        y_idxs.append(idx)
        y_hat, idx, means_4 = dec_pass_update(p, pass_idx, sym_i.float(),
                                              y_hat, common, means_4)
    recon_el, feature = dec_recon(p, y_hat, c1, c2, c3)
    planes = {"finite": finite, "mv_z_hat": mv_z_i, "mv_y_q": mv_y_q_i,
              "mv_idx": mv_idx, "z_hat": z_i, "y_syms": y_syms,
              "y_idxs": y_idxs}
    dpb = {"ref_frame_el": recon_el, "ref_feature_el": feature,
           "warp_frame": warp_frame, "mv_hat": mv_hat}
    return planes, dpb


def write_planes(coder, planes) -> bytes:
    """Host half: rANS-encode one EL frame's planes
    (`LSSVC_net_extend.py:66-74` order)."""
    raise_if_nonfinite("LSSVC EL encode", planes["finite"])
    coder.reset_encoder()
    coder.encode_factorized(planes["mv_z_hat"], coder.z_mv_table)
    coder.encode_gaussian(planes["mv_y_q"], planes["mv_idx"])
    coder.encode_factorized(planes["z_hat"], coder.z_table)
    for sym, idx in zip(planes["y_syms"], planes["y_idxs"]):
        coder.encode_gaussian(sym, idx)
    return coder.flush()


class LSSVCExtend(DecodeProfilingMixin, LSSVC):
    """The two-layer P-frame codec with real bitstreams
    (`LSSVC_net_extend.py`); its base layer is a DMCExtend."""

    BASE_LAYER = DMCExtend
    # the EL decoder's stages, as the JAX package names them
    # (`lssvc_tpu/models/lssvc.py:518-521`): "entropy_dec_y" sums the four
    # passes' rANS decodes, "spatial_prior_update" their prior updates
    DECODING_STAGES = (
        "mv_setup", "entropy_dec_mv_z", "mv_prior_dec", "entropy_dec_mv_y",
        "mv_dec_ctx", "entropy_dec_z", "y_prior", "entropy_dec_y",
        "spatial_prior_update", "res_dec")
    # channels of the EL's mv_z
    channel_mv = 64

    def __init__(self, params: dict, device="cuda", od_offset_cap=None,
                 **mode):
        super().__init__(params, device=device, od_offset_cap=od_offset_cap,
                         **mode)
        self._coder = None
        self._init_decoding_profiling()

    def update(self, force=False):
        """Build both layers' CDF tables (once, or again with `force`)."""
        if self._coder is None or force:
            self._coder = VideoCoder(self.flat_params())
            self.base_layer_model.update(force=force)

    @scoped
    def compress(self, x_el, dpb):
        dpb = sanitize_dpb(dpb)
        texture, mv_bl_hat, y_bl_hat = _depad(dpb, self.pad_size)
        planes, out_dpb = encode_device(
            self.flat_params(), x_el, dpb["ref_frame_el"],
            dpb["ref_feature_el"], texture, mv_bl_hat, y_bl_hat,
            self.shape_hr, self.scale_factor, self.od_offset_cap)
        return {"string": write_planes(self._coder, planes), "dpb": out_dpb}

    @scoped
    def decompress(self, string, height, width, dpb):
        dpb = sanitize_dpb(dpb)
        p = P(self.flat_params())
        coder = self._coder
        timer = self._stage_timer()
        texture, mv_bl_hat, y_bl_hat = _depad(dpb, self.pad_size)
        timer.mark("mv_setup")
        mv_ctx, mv_ctx_prior = dec_mv_setup(p, mv_bl_hat, self.shape_hr,
                                            self.scale_factor)
        timer.mark("entropy_dec_mv_z")
        coder.set_stream(string)
        zh, zw = get_downsampled_shape(height, width, 64)
        mv_z = coder.decode_factorized((1, zh, zw, self.channel_mv),
                                       coder.z_mv_table, self.device)
        timer.mark("mv_prior_dec")
        mv_idx, mv_means = dec_mv_prior(p, mv_z, mv_ctx_prior)
        timer.mark("entropy_dec_mv_y")
        mv_y_q = coder.decode_gaussian(mv_idx)
        timer.mark("mv_dec_ctx")
        mv_hat, c1, c2, c3, _ = dec_contexts(
            p, mv_y_q, mv_means, mv_ctx, texture, dpb["ref_frame_el"],
            dpb["ref_feature_el"], self.shape_hr, self.od_offset_cap)
        timer.mark("entropy_dec_z")
        z = coder.decode_factorized((1, zh, zw, EL_Z_CHANNELS),
                                    coder.z_table, self.device)
        timer.mark("y_prior")
        common = dec_common_params(p, z, c3, y_bl_hat, self.shape_hr)
        idx, means_4 = dec_pass0(common)
        y_hat = None
        for pass_idx in range(4):
            timer.mark("entropy_dec_y")
            y_q_r = coder.decode_gaussian(idx)
            timer.mark("spatial_prior_update")
            y_hat, idx, means_4 = dec_pass_update(p, pass_idx, y_q_r, y_hat,
                                                  common, means_4)
        timer.mark("res_dec")
        recon, feature = dec_recon(p, y_hat, c1, c2, c3)
        timer.finish()
        return {"dpb": {"ref_frame_el": recon, "ref_feature_el": feature},
                "context": c1}

    @scoped
    def encode_decode(self, x_bl, x_el, dpb, output_path_bl, output_path_el,
                      pic_width, pic_height, pic_width_bl, pic_height_bl):
        """Both layers: the BL's stream, then the EL's, each written and
        decoded from its file.  Bits from the file sizes, the four encode
        and decode timers, and the decoded DPB."""
        bl = self.base_layer_model.encode_decode(
            x_bl, dpb, output_path_bl, pic_width_bl, pic_height_bl)
        layer_dpb = bl["dpb"]
        dpb = dict(dpb, texture=layer_dpb["ref_feature_bl"],
                   y_hat_bl=layer_dpb["y_hat_bl"],
                   mv_hat_bl=layer_dpb["mv_hat_bl"])

        t0 = time.perf_counter()
        encoded = self.compress(x_el, dpb)
        encode_p(encoded["string"], output_path_el)
        _sync(self.device)
        t1 = time.perf_counter()
        decoded = self.decompress(decode_p(output_path_el), pic_height,
                                  pic_width, dpb)
        _sync(self.device)
        t2 = time.perf_counter()
        return {
            "dpb": {"ref_frame_bl": layer_dpb["ref_frame_bl"],
                    "ref_feature_bl": layer_dpb["ref_feature_bl"],
                    "ref_frame_el": decoded["dpb"]["ref_frame_el"],
                    "ref_feature_el": decoded["dpb"]["ref_feature_el"]},
            "bit_bl": bl["bit"],
            "bit_el": filesize(output_path_el) * 8,
            "encoding_time_EL": t1 - t0,
            "decoding_time_EL": t2 - t1,
            "encoding_time_BL": bl["encoding_time"],
            "decoding_time_BL": bl["decoding_time"],
            "mv_hat": encoded["dpb"]["mv_hat"],
            "warp_frame": encoded["dpb"]["warp_frame"],
            "context": decoded["context"],
        }
