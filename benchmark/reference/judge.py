"""The plain reference and the comparison that decides a run's `correct`.

The reference is `lssvc_plain`, a frozen copy of the codec's model math
with the kernels' plain formulas, run in the fp32 parity mode (TF32 off)
on the weights and frames the benchmark made.  It imports nothing of the
program and takes none of its tables: it builds its own CDF tables from
the weights and reads the program's bitstreams with its own rANS decoder.

A random-init codec is chaotic: a last-bit difference in a flow moves a
warp's taps over a noise-like feature, and a flipped rounding changes the
priors of its whole neighbourhood, so two codecs that differ only in
precision drift apart within a frame (PERF.md, section 6).  So the
reference follows the program stage by stage, from the program's own
state at each stage's entry, and checks each stage by itself:

  y_err      the analysis transforms: the reference's latents from the
             frame and the program's contexts (P) or decoded BL picture
             (I), against the program's latents;
  mv_err     the motion decoders: the reference's flows from the
             program's motion symbols, against the program's flows;
  ctx_err    the contexts (feature extractors, the flow warps,
             OffsetDiversity's offsets and masks, the fusion nets): the
             reference's contexts from the program's flows and DPB, its
             grouped warp fed the program's offsets, against the program's;
             and the reference's offsets and masks against the program's;
  warp_err   OffsetDiversity's grouped warp: the plain warp of the
             program's source, offsets and masks against its output;
  feat_err   the synthesis transforms: the reference's DPB features (P),
             BL picture and EL feature (I) from the program's symbols and
             contexts, against what the program hands on;
  idx_gap    the priors: the mean |scale index - the reference's| over
             each index plane the program coded with, the worst plane;
  bin_errors the entropy layer, exactly: symbols that the reference's
             rANS decode of the program's .bin files (with the program's
             index planes, each checked by idx_gap) gives otherwise than
             the program's symbols.

Two more hold the chain of frames together, since every stage above is
judged from the program's own state:

  handoff_errors  exactly: elements of the DPB that a frame received which
             differ from what the frame before handed on, its pictures
             clamped to [0, 1] (the runner's clamp between frames);
  sym_errors exactly, decode cells: symbols and scale indexes that the
             decoder reads otherwise than the encoder wrote them at the
             same position of the stream;
  dpb_gap    decode cells: the relative RMS between the DPB that the
             decoder hands on and the one the encoder handed on at the
             same position, each clamped, the worst picture or feature.

Each `*_err` is a relative RMS (the difference's RMS over the reference's
RMS), the worst over the layers, stages and judged frames.  The program's
state at each stage is recorded by `capturing` around its calls (the
program's `models.dmc_stream` / `models.lssvc_stream` module functions and
its I-frame coder's calls); the I-frame, the start of the chain, is judged
from the frame and the program's symbols alone.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from .lssvc_plain.convert import P
from .lssvc_plain.entropy.coder import channel_indexes, to_symbol_order
from .lssvc_plain.entropy.models import build_indexes_img
from .lssvc_plain.models import dmc_stream as ds
from .lssvc_plain.models import lssvc as lssvc_model
from .lssvc_plain.models import lssvc_blocks
from .lssvc_plain.models import lssvc_stream as ls
from .lssvc_plain.models.intra_noar import analysis as bl_analysis
from .lssvc_plain.models.intra_noar import g_s, hyper_params
from .lssvc_plain.models.intra_ss import (IntraSS, context_mining,
                                          el_analysis, el_synthesis)
from .lssvc_plain.models.intra_ss_stream import _depad, el_prior_planes
from .lssvc_plain.models.lssvc import hybrid_context_fusion, mv_res_decoder
from .lssvc_plain.models.lssvc_stream import LSSVCExtend
from .lssvc_plain.native import RansDecoder
from .lssvc_plain.ops.nn import lower_precision, set_fp32_parity
from .lssvc_plain.ops.packed import pack_width
from .lssvc_plain.ops.warp import grouped_warp_plain
from .lssvc_plain.utils.checks import sanitize_dpb

# the reference's package, for `capturing`
PLAIN = __name__.rsplit(".", 1)[0] + ".lssvc_plain"
# the control's precision: the step below the configuration's
LOWER = {"bf16": "fp8", "fp32": "fp8"}
NUMBERS = ("y_err", "mv_err", "ctx_err", "warp_err", "feat_err", "idx_gap",
           "bin_errors", "handoff_errors", "sym_errors", "dpb_gap")
DPB_KEYS = ("ref_frame_bl", "ref_feature_bl", "ref_frame_el",
            "ref_feature_el")
# the planes of a P-frame's two streams: symbols, then scale indexes
P_SYMBOLS = ("mv_z_hat", "mv_y_q", "z_hat", "y_q", "y_syms")
P_INDEXES = ("mv_idx", "y_idx", "y_idxs")


@contextlib.contextmanager
def capturing(package, target):
    """Record, into the dict `target`, what a codec's stage functions
    return while a frame codes: the BL's flow (`dmc_stream.dec_mv`) and
    contexts (`dmc_stream.dec_contexts`); the EL's flow and contexts
    (`lssvc_stream.dec_contexts`), its temporal and spatial contexts with
    the maps that blend them (`lssvc.hybrid_weight_generator`) and
    OffsetDiversity's grouped warp's inputs and output
    (`lssvc_blocks.grouped_warp`); both layers' analysis latents
    (`enc_res_analysis`); and the I-frame's latents, medians, means and
    index planes as its coder takes them (`entropy.coder.IntraCoder`'s
    `eb_compress`, `gc_compress`).  `package` is the program's or the
    reference's (`lssvc_plain`) top-level package name: their modules and
    functions share names."""
    mod = {name: importlib.import_module(f"{package}.{name}") for name in (
        "models.dmc_stream", "models.lssvc_stream", "models.lssvc_blocks",
        "models.lssvc", "entropy.coder")}
    saved = []

    def patch(obj, name, wrap):
        real = getattr(obj, name)
        saved.append((obj, name, real))
        setattr(obj, name, wrap(real))

    def keep(key):
        def wrap(real):
            def call(*args, **kwargs):
                out = real(*args, **kwargs)
                target[key] = _detach(out)
                return out
            return call
        return wrap

    def keep_list(key, args_of):
        def wrap(real):
            def call(self, *args, **kwargs):
                target.setdefault(key, []).append(
                    _detach(args_of(self, *args)))
                return real(self, *args, **kwargs)
            return call
        return wrap

    def keep_warp(real):
        def call(x, flow_x, flow_y, mask, group_num, packed_out=False):
            out = real(x, flow_x, flow_y, mask, group_num, packed_out)
            target["el.warp"] = _detach((x, flow_x, flow_y, mask, out))
            target["el.warp_groups"] = group_num
            return out
        return call

    def keep_maps(real):
        def call(p, ctx_temp, ctx_spat):
            out = real(p, ctx_temp, ctx_spat)
            target["el.maps"] = _detach((ctx_temp, ctx_spat, out))
            return out
        return call

    def keep_el_contexts(real):
        def call(p, mv_y_q, mv_means, mv_ctx, texture, *args, **kwargs):
            out = real(p, mv_y_q, mv_means, mv_ctx, texture, *args, **kwargs)
            target["el.ctx"] = _detach(out)
            target["el.texture"] = _detach(texture)
            return out
        return call

    dmc, el = mod["models.dmc_stream"], mod["models.lssvc_stream"]
    coder = mod["entropy.coder"].IntraCoder
    patch(dmc, "dec_mv", keep("bl.mv_hat"))
    patch(dmc, "dec_contexts", keep("bl.ctx"))
    patch(dmc, "enc_res_analysis", keep("bl.yz"))
    patch(el, "dec_contexts", keep_el_contexts)
    patch(el, "enc_res_analysis", keep("el.yz"))
    patch(mod["models.lssvc_blocks"], "grouped_warp", keep_warp)
    patch(mod["models.lssvc"], "hybrid_weight_generator", keep_maps)
    patch(coder, "eb_compress", keep_list(
        "i.eb", lambda self, z: (z, torch.from_numpy(
            np.asarray(self.medians, dtype=np.float32)))))
    patch(coder, "gc_compress", keep_list(
        "i.gc", lambda self, y, index, means: (y, index, means)))
    try:
        yield target
    finally:
        for obj, name, real in reversed(saved):
            setattr(obj, name, real)


def _detach(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _to(dpb, device):
    """A DPB as f32 on `device` (a missing feature stays None)."""
    return {k: None if v is None else v.to(device).float()
            for k, v in dpb.items()}


def rel_rms(a, ref):
    """RMS of a - ref over the RMS of ref (infinite where the program
    handed on nothing, or a tensor of another shape)."""
    if a is None or tuple(a.shape) != tuple(ref.shape):
        return float("inf")
    ref = ref.float()
    a = a.to(ref.device).float()
    return float(torch.sqrt(torch.mean((a - ref) ** 2))
                 / torch.sqrt(torch.mean(ref ** 2)).clamp_min(1e-12))


class Reference:
    """The reference codec at a configuration's sizes, on `device`."""

    def __init__(self, video_params, intra_params, config, pad, device):
        set_fp32_parity()
        self.device = torch.device(device)
        self.video = LSSVCExtend(video_params, device=self.device,
                                 od_offset_cap=config["od_offset_cap"] or None)
        self.intra = IntraSS(intra_params, device=self.device)
        for m in (self.video, self.intra):
            m.set_scale_information(config["ratio"], pad["el"], (0, 0, 0, 0))
        self.video.update(force=True)
        self.intra.update(force=True)

    def f(self, t):
        return t.to(self.device).float()

    # --- P-frames: the stages from the program's state --------------------

    @torch.no_grad()
    def stages_p(self, frame):
        """Both layers' stages of a P-frame, each from the program's state
        at its entry: ({stage: (program's, reference's)},
        {plane: (program's index plane, reference's)})."""
        f, cap = self.f, frame["cap"]
        bl_p, el_p = frame["planes"]
        model = self.video
        bl = model.base_layer_model
        dpb = sanitize_dpb(_to(frame["dpb_in"], self.device))
        pairs, idx = {}, {}
        with bl.scope():
            p = P(bl.flat_params())
            mv_idx, mv_means = ds.dec_mv_prior(p, f(bl_p["mv_z_hat"]))
            idx["bl.mv"] = (bl_p["mv_idx"], mv_idx)
            pairs["mv.bl"] = (cap["bl.mv_hat"],
                              ds.dec_mv(p, f(bl_p["mv_y_q"]), mv_means))
            c_prog = [f(c) for c in cap["bl.ctx"]]
            pairs["ctx.bl"] = (cap["bl.ctx"], ds.dec_contexts(
                p, f(cap["bl.mv_hat"]), dpb["ref_frame_bl"],
                dpb["ref_feature_bl"]))
            if "bl.yz" in cap:
                pairs["y.bl"] = (cap["bl.yz"][0], ds.enc_res_analysis(
                    p, f(frame["x_bl"]), *c_prog)[0])
            y_idx, y_means = ds.dec_y_prior(p, f(bl_p["z_hat"]), *c_prog)
            idx["bl.y"] = (bl_p["y_idx"], y_idx)
            _, feature_bl, y_hat_bl = ds.dec_recon(
                p, f(bl_p["y_q"]), y_means, *c_prog)
            pairs["feat.bl"] = (frame["dpb_out"]["ref_feature_bl"],
                                feature_bl)
        # the EL's texture is the BL feature the program's EL stage took
        texture = f(cap["el.texture"])
        layer = sanitize_dpb({"texture": texture, "y_hat_bl": y_hat_bl,
                              "mv_hat_bl": f(cap["bl.mv_hat"])})
        with model.scope():
            p = P(model.flat_params())
            _, mv_bl_hat, y_bl_hat = ls._depad(layer, model.pad_size)
            mv_ctx, mv_ctx_prior = ls.dec_mv_setup(
                p, mv_bl_hat, model.shape_hr, model.scale_factor)
            mv_idx, mv_means = ls.dec_mv_prior(p, f(el_p["mv_z_hat"]),
                                               mv_ctx_prior)
            idx["el.mv"] = (el_p["mv_idx"], mv_idx)
            mv_hat_el, *c_el = cap["el.ctx"][:4]
            pairs["mv.el"] = (mv_hat_el, mv_res_decoder(
                p.sub("mv_decoder"), f(el_p["mv_y_q"]) + mv_means, mv_ctx))
            c_prog = [f(c) for c in c_el]
            # OffsetDiversity's warp takes the program's flows and masks
            # (the offsets are checked against the reference's by
            # themselves), and the warp the program's source
            w_x, w_fx, w_fy, w_mask, w_out = cap["el.warp"]
            groups = cap["el.warp_groups"]
            mine = {}

            def warp_as_program(x, flow_x, flow_y, mask, group_num,
                                packed_out=False):
                mine["offsets"] = (flow_x, flow_y, mask)
                out = grouped_warp_plain(x, f(w_fx), f(w_fy), f(w_mask),
                                         group_num)
                return pack_width(out, 2) if packed_out else out

            # and the blend takes the program's maps: a saturated softmax
            # flips where its two logits nearly tie (the maps are checked
            # against the reference's by themselves)
            m_t, m_s, m_out = cap["el.maps"]

            def maps_as_program(p_maps, ctx_temp, ctx_spat):
                mine["maps"] = (ctx_temp, ctx_spat,
                                real_maps(p_maps, ctx_temp, ctx_spat))
                return tuple(tuple(f(m) for m in group) for group in m_out)

            real_warp = lssvc_blocks.grouped_warp
            real_maps = lssvc_model.hybrid_weight_generator
            lssvc_blocks.grouped_warp = warp_as_program
            lssvc_model.hybrid_weight_generator = maps_as_program
            try:
                pairs["ctx.el"] = (c_el, hybrid_context_fusion(
                    p, texture, f(mv_hat_el), dpb["ref_frame_el"],
                    dpb["ref_feature_el"], model.shape_hr,
                    model.od_offset_cap)[:3])
            finally:
                lssvc_blocks.grouped_warp = real_warp
                lssvc_model.hybrid_weight_generator = real_maps
            pairs["ctx.el.offsets"] = ((w_fx, w_fy, w_mask),
                                       mine["offsets"])
            pairs["ctx.el.temporal"] = (m_t, mine["maps"][0])
            pairs["ctx.el.spatial"] = (m_s, mine["maps"][1])
            pairs["maps.el"] = (_flat_tree(m_out), _flat_tree(mine["maps"][2]))
            pairs["warp.el"] = (w_out, grouped_warp_plain(
                f(w_x), f(w_fx), f(w_fy), f(w_mask), groups))
            if "el.yz" in cap:
                pairs["y.el"] = (cap["el.yz"][0], ls.enc_res_analysis(
                    p, f(frame["x_el"]), *c_prog)[0])
            common = ls.dec_common_params(p, f(el_p["z_hat"]), c_prog[2],
                                          y_bl_hat, model.shape_hr)
            y_i, means_4 = ls.dec_pass0(common)
            y_hat = None
            for k in range(4):
                idx[f"el.y{k}"] = (el_p["y_idxs"][k], y_i)
                y_hat, y_i, means_4 = ls.dec_pass_update(
                    p, k, f(el_p["y_syms"][k]), y_hat, common, means_4)
            _, feature_el = ls.dec_recon(p, y_hat, *c_prog)
            pairs["feat.el"] = (frame["dpb_out"]["ref_feature_el"],
                                feature_el)
        return pairs, idx

    def read_bins_p(self, bl_bytes, el_bytes, bl_planes, el_planes):
        """The two P-frame files decoded by the reference's rANS decoder
        with its own CDF tables and the program's index planes: the number
        of symbols that differ from the program's planes."""
        bad = 0
        for coder, data, planes, order in (
                (self.video.base_layer_model._coder, bl_bytes, bl_planes,
                 (("mv_z_hat", None), ("mv_y_q", "mv_idx"), ("z_hat", None),
                  ("y_q", "y_idx"))),
                (self.video._coder, el_bytes, el_planes,
                 (("mv_z_hat", None), ("mv_y_q", "mv_idx"), ("z_hat", None),
                  *((f"y_syms{k}", f"y_idxs{k}") for k in range(4))))):
            dec = RansDecoder()
            (length,) = np.frombuffer(data[:4], dtype=">u4")
            dec.set_stream(data[4:4 + int(length)])
            for name, index in order:
                sym = _plane(planes, name)
                if index is None:
                    table = (coder.z_mv_table if name == "mv_z_hat"
                             else coder.z_table)
                    rows = channel_indexes(tuple(sym.shape))
                else:
                    table = coder.gaussian_table
                    rows = to_symbol_order(_plane(planes, index))
                got = dec.decode_stream(rows, table.cdfs, table.sizes,
                                        table.offsets)
                bad += int((got != to_symbol_order(sym)).sum())
        return bad

    def encode_p(self, frame, lower):
        """The reference at the precision `lower` put in the program's
        place on a P-frame: the frame as it would hand it on (planes,
        features, captured stages), no bitstreams."""
        model = self.video
        bl = model.base_layer_model
        dpb = _to(frame["dpb_in"], self.device)
        cap = {}
        with lower_precision(lower), capturing(PLAIN, cap):
            bl_planes, bl_dpb = bl.encode_planes(self.f(frame["x_bl"]), dpb)
            el_planes, el_dpb = model.encode_planes(
                self.f(frame["x_el"]), dict(
                    dpb, texture=bl_dpb["ref_feature_bl"],
                    y_hat_bl=bl_dpb["y_hat_bl"],
                    mv_hat_bl=bl_dpb["mv_hat_bl"]))
        return dict(frame, planes=(bl_planes, el_planes), bins=None, cap=cap,
                    dpb_out={"ref_feature_bl": bl_dpb["ref_feature_bl"],
                             "ref_feature_el": el_dpb["ref_feature_el"]})

    # --- I-frames -----------------------------------------------------------

    @torch.no_grad()
    def stages_i(self, frame):
        """Both layers of an I-frame, each stage from the program's state:
        (stage pairs, index planes, {stream: the program's symbols})."""
        f, cap = self.f, frame["cap"]
        model = self.intra
        bl = model.base_layer_model
        # the latents as the coder took them (encode), or the values the
        # decoder rebuilt, round(.) + median / means (decode): either way
        # round(latent - median / means) is the symbol
        (_, med_bl), (_, med_el) = cap["i.eb"]
        (y_bl, idx_bl, _), (y_el, idx_el, _) = cap["i.gc"]
        sym = i_symbols(cap)

        def on_card(a):
            return torch.from_numpy(a).to(self.device)

        pairs, idx = {}, {}
        with model.scope():
            pb = bl.flat_params()
            if "x_bl" in frame:
                pairs["y.i.bl"] = (y_bl,
                                   bl_analysis(pb, f(frame["x_bl"]))[0])
            scales, means = hyper_params(pb, on_card(sym["bl.z"])
                                         + f(med_bl))
            idx["i.bl.y"] = (idx_bl, build_indexes_img(scales))
            y_hat_bl = on_card(sym["bl.y"]) + means
            pairs["feat.i.bl"] = (frame["x_hat_bl"],
                                  g_s(P(pb).sub("g_s"), y_hat_bl))
            xb, yb = _depad(model, f(frame["x_hat_bl"]), y_hat_bl)
            params = model.el_params()
            if "x_el" in frame:
                pairs["y.i.el"] = (y_el, el_analysis(
                    params, f(frame["x_el"]), xb, model.shape_hr)[0])
            c1, c2, c3 = context_mining(P(params), xb, model.shape_hr)
            idx_r, means = el_prior_planes(params, on_card(sym["el.z"])
                                           + f(med_el), yb, c3,
                                           model.shape_hr)
            idx["i.el.y"] = (idx_el, idx_r)
            feature, _ = el_synthesis(params, on_card(sym["el.y"]) + means,
                                      c1, c2, c3)
            pairs["feat.i.el"] = (frame["feature_el"], feature)
        return pairs, idx, sym

    def read_bins_i(self, bl_bytes, el_bytes, sym, idx):
        """The two I-frame files (`utils/stream.py` layout: four big-endian
        u32, then the y and the z stream), each stream decoded with the
        reference's tables and the program's index planes: the symbols
        that differ from the program's."""
        bad = 0
        for tag, data, coder in (("bl", bl_bytes,
                                  self.intra.base_layer_model._coder),
                                 ("el", el_bytes, self.intra._coder)):
            _, _, ylen, zlen = (int(v) for v in
                                np.frombuffer(data[:16], dtype=">u4"))
            y_str = data[16:16 + ylen]
            z_str = data[16 + ylen:16 + ylen + zlen]
            z_sym = sym[f"{tag}.z"]
            dec = RansDecoder()
            got = dec.decode_with_indexes(
                z_str, channel_indexes(z_sym.shape), coder.eb_table.cdfs,
                coder.eb_table.sizes, coder.eb_table.offsets)
            bad += int((got != _nchw_flat(z_sym)).sum())
            index = idx[f"i.{tag}.y"][0].cpu().numpy()
            got = dec.decode_with_indexes(
                y_str, _nchw_flat(index), coder.gc_table.cdfs,
                coder.gc_table.sizes, coder.gc_table.offsets)
            bad += int((got != _nchw_flat(sym[f"{tag}.y"])).sum())
        return bad

    @torch.no_grad()
    def encode_i(self, frame, lower):
        """The reference at `lower` in the program's place on an I-frame:
        the closed-loop encoder (`intra_ss_stream.compress_stream`) with
        the rANS round trips replaced by the values they carry; the frame
        as it would hand it on, its coder's inputs captured."""
        model = self.intra
        bl = model.base_layer_model
        x_bl, x_el = self.f(frame["x_bl"]), self.f(frame["x_el"])
        cap = {"i.eb": [], "i.gc": []}

        def roundtrip(t, sub):
            return torch.round(t.float() - sub) + sub

        with lower_precision(lower), model.scope():
            pb = bl.flat_params()
            y, z = bl_analysis(pb, x_bl)
            med = self.f(torch.from_numpy(np.asarray(bl._coder.medians,
                                                     dtype=np.float32)))
            scales, means = hyper_params(pb, roundtrip(z, med))
            cap["i.eb"].append((z, med))
            cap["i.gc"].append((y, build_indexes_img(scales), means))
            y_hat = roundtrip(y, means.float())
            x_hat_bl = g_s(P(pb).sub("g_s"), y_hat)
            xb, yb = _depad(model, x_hat_bl, y_hat)
            params = model.el_params()
            y_el, z_el, _ = el_analysis(params, x_el, xb, model.shape_hr)
            c1, c2, c3 = context_mining(P(params), xb, model.shape_hr)
            med = self.f(torch.from_numpy(np.asarray(model._coder.medians,
                                                     dtype=np.float32)))
            idx, means = el_prior_planes(params, roundtrip(z_el, med), yb,
                                         c3, model.shape_hr)
            cap["i.eb"].append((z_el, med))
            cap["i.gc"].append((y_el, idx, means))
            feature, _ = el_synthesis(params, roundtrip(y_el, means.float()),
                                      c1, c2, c3)
        return dict(frame, cap=cap, bins=None, x_hat_bl=x_hat_bl,
                    feature_el=feature)


def decode_lower(ref: Reference, frame, lower):
    """The reference at `lower` in the place of the program's decoder, on
    the symbols the program decoded: the frame as it would hand it on
    (its stages, index planes and features)."""
    f = ref.f
    cap = {}
    with torch.no_grad(), lower_precision(lower), capturing(PLAIN, cap):
        if frame["kind"] == "I":
            return _decode_lower_i(ref, frame, cap)
        bl_p, el_p = frame["planes"]
        model = ref.video
        bl = model.base_layer_model
        dpb = sanitize_dpb(_to(frame["dpb_in"], ref.device))
        with bl.scope():
            p = P(bl.flat_params())
            mv_idx, mv_means = ds.dec_mv_prior(p, f(bl_p["mv_z_hat"]))
            mv_hat_bl = ds.dec_mv(p, f(bl_p["mv_y_q"]), mv_means)
            c = ds.dec_contexts(p, mv_hat_bl, dpb["ref_frame_bl"],
                                dpb["ref_feature_bl"])
            y_idx, y_means = ds.dec_y_prior(p, f(bl_p["z_hat"]), *c)
            recon_bl, feature_bl, y_hat_bl = ds.dec_recon(
                p, f(bl_p["y_q"]), y_means, *c)
        layer = sanitize_dpb({"texture": feature_bl, "y_hat_bl": y_hat_bl,
                              "mv_hat_bl": mv_hat_bl})
        with model.scope():
            p = P(model.flat_params())
            texture, mv_bl_hat, y_bl_hat = ls._depad(layer, model.pad_size)
            mv_ctx, mv_ctx_prior = ls.dec_mv_setup(
                p, mv_bl_hat, model.shape_hr, model.scale_factor)
            el_mv_idx, mv_means = ls.dec_mv_prior(p, f(el_p["mv_z_hat"]),
                                                  mv_ctx_prior)
            _, c1, c2, c3, _ = ls.dec_contexts(
                p, f(el_p["mv_y_q"]), mv_means, mv_ctx, texture,
                dpb["ref_frame_el"], dpb["ref_feature_el"], model.shape_hr,
                model.od_offset_cap)
            common = ls.dec_common_params(p, f(el_p["z_hat"]), c3, y_bl_hat,
                                          model.shape_hr)
            y_i, means_4 = ls.dec_pass0(common)
            y_hat, idxs = None, []
            for k in range(4):
                idxs.append(y_i)
                y_hat, y_i, means_4 = ls.dec_pass_update(
                    p, k, f(el_p["y_syms"][k]), y_hat, common, means_4)
            recon_el, feature_el = ls.dec_recon(p, y_hat, c1, c2, c3)
    planes = (dict(bl_p, mv_idx=mv_idx, y_idx=y_idx),
              dict(el_p, mv_idx=el_mv_idx, y_idxs=idxs))
    return dict(frame, cap=cap, planes=planes, bins=None,
                dpb_out={"ref_frame_bl": recon_bl,
                         "ref_feature_bl": feature_bl,
                         "ref_frame_el": recon_el,
                         "ref_feature_el": feature_el})


def _decode_lower_i(ref, frame, cap):
    f = ref.f
    model = ref.intra
    bl = model.base_layer_model
    (z_bl, med_bl), (z_el, med_el) = frame["cap"]["i.eb"]
    (y_bl, _, means_bl), (y_el, _, means_el) = frame["cap"]["i.gc"]
    with model.scope():
        pb = bl.flat_params()
        z_hat = f(torch.from_numpy(_round_np(z_bl, med_bl))) + f(med_bl)
        scales, means = hyper_params(pb, z_hat)
        y_hat = f(torch.from_numpy(_round_np(y_bl, means_bl))) + means
        cap["i.eb"] = [(z_hat, med_bl)]
        cap["i.gc"] = [(y_hat, build_indexes_img(scales), means)]
        x_hat_bl = g_s(P(pb).sub("g_s"), y_hat)
        xb, yb = _depad(model, x_hat_bl, y_hat)
        params = model.el_params()
        c1, c2, c3 = context_mining(P(params), xb, model.shape_hr)
        z_hat = f(torch.from_numpy(_round_np(z_el, med_el))) + f(med_el)
        idx, means = el_prior_planes(params, z_hat, yb, c3, model.shape_hr)
        y_hat = f(torch.from_numpy(_round_np(y_el, means_el))) + means
        cap["i.eb"].append((z_hat, med_el))
        cap["i.gc"].append((y_hat, idx, means))
        feature, x_hat_el = el_synthesis(params, y_hat, c1, c2, c3)
    return dict(frame, cap=cap, bins=None, x_hat_bl=x_hat_bl,
                feature_el=feature,
                dpb_out={"ref_frame_bl": x_hat_bl, "ref_feature_bl": None,
                         "ref_frame_el": x_hat_el,
                         "ref_feature_el": feature})


def _flat_tree(tree):
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat_tree(v)]
    return [tree]


def _round_np(t, sub):
    """The coder's f32 symbol boundary on the host: round(t - sub) in
    numpy float32 (`entropy/coder.py` `eb_compress`, `gc_compress`)."""
    a = t.detach().float().cpu().numpy()
    b = sub.detach().float().cpu().numpy()
    return np.round(a - b).astype(np.float32)


def _nchw_flat(a):
    """An NHWC array of one image in the coder's NCHW-flat order."""
    return np.asarray(a)[0].transpose(2, 0, 1).reshape(-1)


def _plane(planes, name):
    if name.startswith("y_syms") or name.startswith("y_idxs"):
        return planes[name[:6]][int(name[6:])]
    return planes[name]


def numbers_of(pairs, idx) -> dict:
    """The numbers of one frame from its stage pairs and index planes;
    with each stage's own reading beside them (`<stage>.<layer>`)."""
    out = {}
    for name, (prog, mine) in pairs.items():
        if isinstance(prog, (list, tuple)):
            out[name] = max(rel_rms(a, b) for a, b in zip(prog, mine))
        else:
            out[name] = rel_rms(prog, mine)
    for key, stage in (("y_err", "y"), ("mv_err", "mv"), ("ctx_err", "ctx"),
                       ("warp_err", "warp"), ("feat_err", "feat")):
        got = [v for k, v in out.items() if k.split(".")[0] == stage]
        if got:
            out[key] = max(got)
    for name, (prog, mine) in idx.items():
        out[f"idx_gap.{name}"] = float(
            (prog.to(mine.device).long() - mine.long()).abs().float().mean())
    out["idx_gap"] = max(v for k, v in out.items()
                         if k.startswith("idx_gap."))
    return out


def judge_p(ref: Reference, frame):
    """The numbers of one P-frame, the program's or a control's (which
    brings no bitstreams)."""
    pairs, idx = ref.stages_p(frame)
    out = numbers_of(pairs, idx)
    if frame.get("bins") is not None:
        out["bin_errors"] = float(ref.read_bins_p(*frame["bins"],
                                                  *frame["planes"]))
    return out


def judge_i(ref: Reference, frame):
    pairs, idx, sym = ref.stages_i(frame)
    out = numbers_of(pairs, idx)
    if frame.get("bins") is not None:
        out["bin_errors"] = float(ref.read_bins_i(*frame["bins"], sym, idx))
    return out


def merge(readings: list[dict]) -> dict:
    """The worst of each number over the judged frames."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict, expected: tuple) -> tuple:
    """(correct, [(name, number, limit)]): every expected number present
    and at most its limit."""
    rows = [(k, numbers.get(k), limits[k]) for k in expected]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows


# --- the chain of frames -----------------------------------------------------

def clamped(dpb) -> dict:
    """A DPB as the next frame takes it: the pictures clamped to [0, 1]."""
    return {k: None if dpb.get(k) is None else
            torch.clamp(dpb[k], 0.0, 1.0) if k.startswith("ref_frame")
            else dpb[k] for k in DPB_KEYS}


def differing(a, b) -> int:
    """Elements in which two tensors differ (NaN equals NaN); all of them
    where one is missing or the shapes differ."""
    if a is None or b is None:
        return sum(x.numel() for x in (a, b) if x is not None)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel())
    a = a.to(b.device)
    if a.dtype != b.dtype:
        a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def handoff_errors(sent, received) -> float:
    """Elements of the DPBs in `received` ({frame: the DPB it was given})
    that differ from `sent` ({frame: the DPB the frame before it handed
    on}) once clamped."""
    return float(sum(differing(clamped(sent[n])[k], received[n].get(k))
                     for n in received for k in DPB_KEYS))


def _flat_planes(planes, names):
    out = {}
    for tag, layer in zip(("bl", "el"), planes):
        for name in names:
            v = layer.get(name)
            if isinstance(v, (list, tuple)):
                out.update({f"{tag}.{name}{k}": x for k, x in enumerate(v)})
            elif v is not None:
                out[f"{tag}.{name}"] = v
    return out


def i_symbols(cap) -> dict:
    """An I-frame's symbols and index planes from its coder's recorded
    calls (`capturing` on the encoder, `decode_capture` on the decoder)."""
    (z_bl, med_bl), (z_el, med_el) = cap["i.eb"]
    (y_bl, idx_bl, means_bl), (y_el, idx_el, means_el) = cap["i.gc"]
    return {"bl.z": _round_np(z_bl, med_bl), "bl.y": _round_np(y_bl, means_bl),
            "el.z": _round_np(z_el, med_el), "el.y": _round_np(y_el, means_el),
            "bl.y_idx": idx_bl, "el.y_idx": idx_el}


def sync_numbers(decoded, encoded) -> dict:
    """The decoder's frame against the encoder's at the same position of
    the stream: `sym_errors`, `dpb_gap`."""
    if decoded["kind"] != encoded["kind"]:
        return {"sym_errors": float("inf"), "dpb_gap": float("inf")}
    if decoded["kind"] == "P":
        names = P_SYMBOLS + P_INDEXES
        mine = _flat_planes(decoded["planes"], names)
        theirs = _flat_planes(encoded["planes"], names)
    else:
        mine, theirs = i_symbols(decoded["cap"]), i_symbols(encoded["cap"])
    bad = sum(differing(mine.get(k), theirs.get(k))
              for k in set(mine) | set(theirs))
    return {"sym_errors": float(bad),
            "dpb_gap": dpb_gap(decoded["dpb_out"], encoded["dpb_out"])}


def dpb_gap(decoded, encoded) -> float:
    """The worst relative RMS of a decoder's DPB (picture or feature)
    against the encoder's, each clamped."""
    dec, enc = clamped(decoded), clamped(encoded)
    return max(rel_rms(dec[k], enc[k]) for k in DPB_KEYS
               if enc[k] is not None)
