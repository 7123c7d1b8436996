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
from concurrent.futures import ThreadPoolExecutor

import torch

from ..convert import P
from ..entropy.coder import VideoCoder, from_symbol_order, to_symbol_order
from ..entropy.models import build_indexes_video
from ..ops import pad_nhwc
from ..utils import spans
from ..utils.checks import finite_flags, raise_if_nonfinite, sanitize_dpb
from ..utils.host import HostCopy, Stamps
from ..utils.stream import decode_p, encode_p, filesize, \
    get_downsampled_shape
from .components import cat, me_spynet
from . import dmc_stream as ds
from .dmc_stream import DecodeFrame, DecodeProfilingMixin, DMCExtend, \
    _sync, quantize_i
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
# the spans of the EL decoder's four checkerboard passes
Y_PASS_SPANS = tuple(f"lssvc.p.decode.el.y_pass{i}" for i in range(4))


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
    with spans.span("lssvc.entropy.encode"):
        raise_if_nonfinite("LSSVC EL encode", planes["finite"])
        coder.reset_encoder()
        coder.encode_factorized(planes["mv_z_hat"], coder.z_mv_table)
        coder.encode_gaussian(planes["mv_y_q"], planes["mv_idx"])
        coder.encode_factorized(planes["z_hat"], coder.z_table)
        for sym, idx in zip(planes["y_syms"], planes["y_idxs"]):
            coder.encode_gaussian(sym, idx)
        return coder.flush()


def _gaussian_host(dec, index: HostCopy):
    """Host half of a gaussian plane's decode (worker-safe): the symbols of
    the index plane once its copy has landed."""
    return dec.gaussian_symbols(to_symbol_order(index.get()))


def decode_frame_overlapped(model, string_bl, string_el, h_bl, w_bl, h_el,
                            w_el, dpb, pool, stamps: Stamps | None = None):
    """The two-layer P-frame decoder (the JAX package's
    `models/pipeline.py:128`): both layers' stage functions, the same as
    `DMCExtend.decompress` then `LSSVCExtend.decompress` run on the same
    planes, so the DPB is theirs bit for bit, ordered so that the host
    rANS overlaps the card:

      * the factorized planes (BL z, EL mv_z and z), whose indexes are
        static, decode while a context stage runs on the card;
      * the BL y plane and the EL mv_y plane, in different streams,
        rANS-decode on `pool`'s worker thread (the C calls drop the GIL)
        while the card runs the other layer's stages;
      * each index plane's copy to the host starts on the main thread
        behind an event, and the planes decoded on the host go back to
        the card from the main thread.

    Spans (`utils/spans.py`): the frame `lssvc.p.decode`; each stage of
    either layer `lssvc.p.decode.bl.<stage>` / `.el.<stage>` (the
    DECODING_STAGES), the EL's four checkerboard passes
    `lssvc.p.decode.el.y_pass<i>` around their stages; the rANS decodes
    `lssvc.entropy.decode`, on either thread; each wait for the worker
    `lssvc.wait.worker`; each wait for an index plane's copy
    `lssvc.wait.d2h`; and each decoded plane's copy back to the card
    `lssvc.wait.h2d`, a copy from pageable memory after which the stream
    synchronises, so the host waits there for every launch before it
    (`entropy.coder.from_symbol_order`); the stages' own copies of
    constants to the card are such waits too (the GDN and clip bounds,
    the flow clamp, the checkerboard masks, OffsetDiversity's fusion
    scatter).

    model: an LSSVCExtend with its tables built and its scale set; dpb:
    the DPB after the runner's clamp.  With the model's `profile_decoding`
    each stage is charged to its layer's profiling dict
    (`dmc_stream.DecodeFrame`: a plane decoded on the worker counts only
    the wait for it; the work between two stages, such as a submit to the
    worker or an index plane's copy, is in the stage before it), and each
    layer's "overall" is the two-layer frame's seconds from its first
    stage to its last.  `stamps`, if given, is stamped once the BL picture is
    enqueued.  Returns {"dpb", "bl_dpb", "mv_hat", "context"}."""
    bl = model.base_layer_model
    coder_bl, coder_el = bl._coder, model._coder
    p_bl, p_el = P(bl.flat_params()), P(model.flat_params())
    device = model.device
    zb = (1, *get_downsampled_shape(h_bl, w_bl, 64), bl.channel_N)
    zh_e, zw_e = get_downsampled_shape(h_el, w_el, 64)
    pad = model.pad_size
    shape_hr = model.shape_hr

    def on_card(vals, shape):
        return from_symbol_order(vals, shape, device)

    def worker(future):
        with spans.span("lssvc.wait.worker"):
            return future.result()

    with torch.no_grad(), DecodeFrame(model, bl) as frame:
        dec_bl = coder_bl.open_stream(string_bl)
        dec_el = coder_el.open_stream(string_el)
        dpb = sanitize_dpb(dpb)

        def bl_stage(key):
            return frame.stage(bl, key)

        def el_stage(key):
            return frame.stage(model, key)

        # --- BL head; the EL's mv_z decodes on the worker meanwhile
        with bl_stage("entropy_dec_mv_z"):
            mv_z = dec_bl.decode_factorized(zb, coder_bl.z_mv_table, device)
            el_mvz_shape = (1, zh_e, zw_e, model.channel_mv)
            el_mvz = pool.submit(spans.carry(dec_el.factorized_symbols),
                                 el_mvz_shape, coder_el.z_mv_table)
        with bl_stage("mv_y_prior_dec"), bl.scope():
            mv_idx, mv_means = ds.dec_mv_prior(p_bl, mv_z)
        with bl_stage("entropy_dec_mv_y"):
            mv_y_q = on_card(_gaussian_host(dec_bl, HostCopy(mv_idx)),
                             mv_idx.shape)
        with bl_stage("mv_dec"), bl.scope():
            mv_hat_bl = ds.dec_mv(p_bl, mv_y_q, mv_means)
        with bl_stage("motion_compensation_ctx_refine"), bl.scope():
            c1b, c2b, c3b = ds.dec_contexts(p_bl, mv_hat_bl,
                                            dpb["ref_frame_bl"],
                                            dpb["ref_feature_bl"])
        # BL z: static indexes, decodes while the context stage runs
        with bl_stage("entropy_dec_z"):
            z = dec_bl.decode_factorized(zb, coder_bl.z_table, device)
        with bl_stage("y_prior"):
            with bl.scope():
                y_idx, y_means = ds.dec_y_prior(p_bl, z, c1b, c2b, c3b)
            y_idx_host = HostCopy(y_idx)

        # --- EL motion setup: needs only the BL's mv_hat
        with el_stage("mv_setup"):
            mv_bl_hat = pad_nhwc(
                sanitize_dpb({"mv_hat_bl": mv_hat_bl})["mv_hat_bl"], pad)
            with model.scope():
                mv_ctx, mv_ctx_prior = dec_mv_setup(p_el, mv_bl_hat,
                                                    shape_hr,
                                                    model.scale_factor)
        with el_stage("entropy_dec_mv_z"):
            mv_z_el = on_card(worker(el_mvz), el_mvz_shape)
        with el_stage("mv_prior_dec"):
            with model.scope():
                el_mv_idx, el_mv_means = dec_mv_prior(p_el, mv_z_el,
                                                      mv_ctx_prior)
            # --- the BL's y plane, then the EL's mv_y (two streams),
            # decode on the worker: BL y while the card runs the EL's
            # motion setup and prior, EL mv_y while it runs the BL's recon
            bl_y = pool.submit(spans.carry(_gaussian_host), dec_bl,
                               y_idx_host)
            el_mv_y = pool.submit(spans.carry(_gaussian_host), dec_el,
                                  HostCopy(el_mv_idx))
        with bl_stage("entropy_dec_y"):
            y_q = on_card(worker(bl_y), y_idx.shape)
        with bl_stage("res_dec"):
            with bl.scope():
                recon_bl, feature_bl, y_hat_bl = ds.dec_recon(
                    p_bl, y_q, y_means, c1b, c2b, c3b)
            if stamps is not None:
                stamps.stamp()
        bl_dpb = {"ref_frame_bl": recon_bl, "ref_feature_bl": feature_bl,
                  "y_hat_bl": y_hat_bl, "mv_hat_bl": mv_hat_bl}
        with el_stage("entropy_dec_mv_y"):
            el_mv_y = on_card(worker(el_mv_y), el_mv_idx.shape)

        # --- EL contexts, then the residual's four passes
        with el_stage("mv_dec_ctx"):
            layer = sanitize_dpb({"texture": feature_bl,
                                  "y_hat_bl": y_hat_bl,
                                  "mv_hat_bl": mv_hat_bl})
            texture, _, y_bl_hat = _depad(layer, pad)
            with model.scope():
                mv_hat_el, c1, c2, c3, _ = dec_contexts(
                    p_el, el_mv_y, el_mv_means, mv_ctx, texture,
                    dpb["ref_frame_el"], dpb["ref_feature_el"], shape_hr,
                    model.od_offset_cap)
        # EL z: static indexes, decodes while the context stage runs
        with el_stage("entropy_dec_z"):
            z_el = dec_el.decode_factorized((1, zh_e, zw_e, EL_Z_CHANNELS),
                                            coder_el.z_table, device)
        with el_stage("y_prior"), model.scope():
            common = dec_common_params(p_el, z_el, c3, y_bl_hat, shape_hr)
            idx, means_4 = dec_pass0(common)
        y_hat = None
        for pass_idx in range(4):
            with spans.span(Y_PASS_SPANS[pass_idx]):
                with el_stage("entropy_dec_y"):
                    y_q_r = on_card(_gaussian_host(dec_el, HostCopy(idx)),
                                    idx.shape)
                with el_stage("spatial_prior_update"), model.scope():
                    y_hat, idx, means_4 = dec_pass_update(
                        p_el, pass_idx, y_q_r, y_hat, common, means_4)
        with el_stage("res_dec"), model.scope():
            recon_el, feature_el = dec_recon(p_el, y_hat, c1, c2, c3)

    return {"dpb": {"ref_frame_bl": recon_bl, "ref_feature_bl": feature_bl,
                    "ref_frame_el": recon_el, "ref_feature_el": feature_el},
            "bl_dpb": bl_dpb, "mv_hat": mv_hat_el, "context": c1}


class LSSVCExtend(DecodeProfilingMixin, LSSVC):
    """The two-layer P-frame codec with real bitstreams
    (`LSSVC_net_extend.py`); its base layer is a DMCExtend."""

    BASE_LAYER = DMCExtend
    # the EL decoder's stages, as the JAX package names them
    # (`lssvc_tpu/models/lssvc.py:518-521`; spans SPAN_PREFIX + stage):
    # "entropy_dec_y" sums the four passes' rANS decodes,
    # "spatial_prior_update" their prior updates
    SPAN_PREFIX = "lssvc.p.decode.el."
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
    def encode_planes(self, x_el, dpb):
        """The device half of `compress`: (planes, dpb), nothing read on
        the host (`models/pipeline.py` writes the planes on a worker)."""
        dpb = sanitize_dpb(dpb)
        texture, mv_bl_hat, y_bl_hat = _depad(dpb, self.pad_size)
        return encode_device(
            self.flat_params(), x_el, dpb["ref_frame_el"],
            dpb["ref_feature_el"], texture, mv_bl_hat, y_bl_hat,
            self.shape_hr, self.scale_factor, self.od_offset_cap)

    def compress(self, x_el, dpb):
        planes, out_dpb = self.encode_planes(x_el, dpb)
        return {"string": write_planes(self._coder, planes), "dpb": out_dpb}

    @scoped
    def decompress(self, string, height, width, dpb):
        dpb = sanitize_dpb(dpb)
        p = P(self.flat_params())
        coder = self._coder
        with DecodeFrame(self) as frame:
            texture, mv_bl_hat, y_bl_hat = _depad(dpb, self.pad_size)
            with frame.stage(self, "mv_setup"):
                mv_ctx, mv_ctx_prior = dec_mv_setup(
                    p, mv_bl_hat, self.shape_hr, self.scale_factor)
            with frame.stage(self, "entropy_dec_mv_z"):
                coder.set_stream(string)
                zh, zw = get_downsampled_shape(height, width, 64)
                mv_z = coder.decode_factorized((1, zh, zw, self.channel_mv),
                                               coder.z_mv_table, self.device)
            with frame.stage(self, "mv_prior_dec"):
                mv_idx, mv_means = dec_mv_prior(p, mv_z, mv_ctx_prior)
            with frame.stage(self, "entropy_dec_mv_y"):
                mv_y_q = coder.decode_gaussian(mv_idx)
            with frame.stage(self, "mv_dec_ctx"):
                mv_hat, c1, c2, c3, _ = dec_contexts(
                    p, mv_y_q, mv_means, mv_ctx, texture, dpb["ref_frame_el"],
                    dpb["ref_feature_el"], self.shape_hr, self.od_offset_cap)
            with frame.stage(self, "entropy_dec_z"):
                z = coder.decode_factorized((1, zh, zw, EL_Z_CHANNELS),
                                            coder.z_table, self.device)
            with frame.stage(self, "y_prior"):
                common = dec_common_params(p, z, c3, y_bl_hat, self.shape_hr)
                idx, means_4 = dec_pass0(common)
            y_hat = None
            for pass_idx in range(4):
                with spans.span(Y_PASS_SPANS[pass_idx]):
                    with frame.stage(self, "entropy_dec_y"):
                        y_q_r = coder.decode_gaussian(idx)
                    with frame.stage(self, "spatial_prior_update"):
                        y_hat, idx, means_4 = dec_pass_update(
                            p, pass_idx, y_q_r, y_hat, common, means_4)
            with frame.stage(self, "res_dec"):
                recon, feature = dec_recon(p, y_hat, c1, c2, c3)
        return {"dpb": {"ref_frame_el": recon, "ref_feature_el": feature},
                "context": c1}

    @scoped
    def encode_decode(self, x_bl, x_el, dpb, output_path_bl, output_path_el,
                      pic_width, pic_height, pic_width_bl, pic_height_bl):
        """Both layers: the BL's stream, then the EL's, each written; then
        both files decoded by the two-layer decoder
        (`decode_frame_overlapped`).  Bits from the file sizes, the four
        timers (a layer's decoding time is the decoder's time up to its
        picture: the BL's, then the rest, the EL's) and the decoded
        DPB."""
        bl = self.base_layer_model
        t0 = time.perf_counter()
        encoded_bl = bl.compress(x_bl, dpb)
        encode_p(encoded_bl["string"], output_path_bl)
        _sync(self.device)
        t1 = time.perf_counter()
        layer_dpb = encoded_bl["dpb"]  # the decoder's, bit for bit
        encoded = self.compress(x_el, dict(
            dpb, texture=layer_dpb["ref_feature_bl"],
            y_hat_bl=layer_dpb["y_hat_bl"], mv_hat_bl=layer_dpb["mv_hat_bl"]))
        encode_p(encoded["string"], output_path_el)
        _sync(self.device)
        t2 = time.perf_counter()
        stamps = Stamps(self.device)
        stamps.stamp()
        with ThreadPoolExecutor(max_workers=1) as pool:
            decoded = decode_frame_overlapped(
                self, decode_p(output_path_bl), decode_p(output_path_el),
                pic_height_bl, pic_width_bl, pic_height, pic_width, dpb,
                pool, stamps)
        stamps.stamp()
        _sync(self.device)
        return {
            "dpb": decoded["dpb"],
            "bit_bl": filesize(output_path_bl) * 8,
            "bit_el": filesize(output_path_el) * 8,
            "encoding_time_EL": t2 - t1,
            "decoding_time_EL": stamps.seconds(1, 2),
            "encoding_time_BL": t1 - t0,
            "decoding_time_BL": stamps.seconds(0, 1),
            "mv_hat": encoded["dpb"]["mv_hat"],
            "warp_frame": encoded["dpb"]["warp_frame"],
            "context": decoded["context"],
        }
