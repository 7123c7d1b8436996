"""DMCExtend: the base layer's real bitstreams (the JAX package's
`models/dmc.py:228-308` and `models/dmc_stream.py`; reference
`dmc_net_extend.py:55-147`).

One buffered rANS stream per P-frame, in the order mv_z, mv_y, z, y.  The
decoder runs in stages split at the entropy decodes (each decoded tensor
conditions the next priors); activations stay on the device between them.

**Closed-loop encoder.**  The encoder runs the analysis fronts
(`enc_mv_analysis`, `enc_res_analysis`) and then the decoder's own stage
functions on the int-normalised symbol planes (int32, exactly what the
decoder decodes), for every scale-index and means plane it writes and for
the DPB it returns.  A prior computed another way could differ in its
last bits, flip a scale-index bucket and desynchronise the stream for the
rest of the frame.  Run in the same process, or in another process on the
same kind of device, the same calls give the same bits, so the encoder's
DPB is the decoder's.
"""

from __future__ import annotations

import time

import torch

from ..convert import P
from ..entropy.coder import VideoCoder
from ..entropy.models import build_indexes_video
from ..utils import spans
from ..utils.checks import finite_flags, raise_if_nonfinite, sanitize_dpb
from ..utils.stream import decode_p, encode_p, filesize, \
    get_downsampled_shape
from .base import scoped
from .components import (
    cat,
    gdn_res_decoder,
    gdn_res_encoder,
    me_spynet,
    recon_generation_simple,
    temporal_prior_encoder_gdn,
)
from .dmc import (
    DMC,
    entropy_parameters,
    hyper_decoder,
    hyper_encoder,
    motion_compensation,
    mv_decoder,
    mv_encoder,
)


def quantize_i(y, means):
    """Symbol plane: round(y - means) as int32, the values the coder
    carries and the decoder stages consume; the subtract runs in f32 in
    every mode (the f32 symbol boundary of `entropy/coder.py`: in bf16 a
    bf16 subtract would round first)."""
    return torch.round(y.float() - means.float()).to(torch.int32)


def _split_indexes(params_out):
    half = params_out.shape[-1] // 2
    return build_indexes_video(params_out[..., :half]), params_out[..., half:]


# --- the encoder's analysis fronts ------------------------------------------

def enc_mv_analysis(p, x, ref_frame):
    """SpyNet -> mv AE -> hyper AE; returns mv_y and the mv_z symbols."""
    est_mv = me_spynet(p.sub("optic_flow"), x, ref_frame)
    mv_y = mv_encoder(p.sub("mv_encoder"), est_mv)
    mv_z = hyper_encoder(p.sub("mv_prior_encoder"), mv_y)
    return mv_y, mv_z


def enc_res_analysis(p, x, c1, c2, c3):
    """Contextual AE -> hyper AE; returns y and z."""
    y = gdn_res_encoder(p.sub("res_encoder"), x, c1, c2, c3)
    z = hyper_encoder(p.sub("res_prior_encoder"), y)
    return y, z


# --- the decoder's stages ---------------------------------------------------

def dec_mv_prior(p, mv_z_hat):
    return _split_indexes(hyper_decoder(p.sub("mv_prior_decoder"), mv_z_hat))


def dec_mv(p, mv_y_q, mv_means):
    return mv_decoder(p.sub("mv_decoder"), mv_y_q + mv_means)


def dec_contexts(p, mv_hat, ref_frame, ref_feature):
    c1, c2, c3, _ = motion_compensation(p, ref_frame, ref_feature, mv_hat)
    return c1, c2, c3


def dec_y_prior(p, z_hat, c1, c2, c3):
    hierarchical = hyper_decoder(p.sub("res_prior_decoder"), z_hat)
    temporal = temporal_prior_encoder_gdn(p.sub("temporal_prior_encoder"),
                                          c1, c2, c3)
    return _split_indexes(entropy_parameters(
        p.sub("res_entropy_parameter"), cat([temporal, hierarchical])))


def dec_recon(p, y_q, means, c1, c2, c3):
    y_hat = y_q + means
    recon_feature = gdn_res_decoder(p.sub("res_decoder"), y_hat, c2, c3)
    feature, recon = recon_generation_simple(p.sub("recon_generation_net"),
                                             recon_feature, c1)
    return torch.clamp(recon, 0.0, 1.0), feature, y_hat


def encode_device(params, x, ref_frame, ref_feature):
    """All device work of one BL frame, closed loop (module docstring).
    Returns (planes, dpb) on the device; nothing crosses to the host."""
    p = P(params)
    mv_y, mv_z = enc_mv_analysis(p, x, ref_frame)
    mv_z_i = torch.round(mv_z.float()).to(torch.int32)
    mv_idx, mv_means = dec_mv_prior(p, mv_z_i.float())
    mv_y_q_i = quantize_i(mv_y, mv_means)
    mv_hat = dec_mv(p, mv_y_q_i.float(), mv_means)
    c1, c2, c3 = dec_contexts(p, mv_hat, ref_frame, ref_feature)
    y, z = enc_res_analysis(p, x, c1, c2, c3)
    z_i = torch.round(z.float()).to(torch.int32)
    y_idx, y_means = dec_y_prior(p, z_i.float(), c1, c2, c3)
    y_q_i = quantize_i(y, y_means)
    recon, feature, y_hat = dec_recon(p, y_q_i.float(), y_means, c1, c2, c3)
    planes = {
        # read on the host in write_planes, after the frame is queued
        "finite": finite_flags(mv_y=mv_y, mv_z=mv_z, mv_means=mv_means,
                               y=y, z=z, y_means=y_means),
        "mv_z_hat": mv_z_i, "mv_y_q": mv_y_q_i, "mv_idx": mv_idx,
        "z_hat": z_i, "y_q": y_q_i, "y_idx": y_idx,
    }
    dpb = {"ref_frame_bl": recon, "ref_feature_bl": feature,
           "y_hat_bl": y_hat, "mv_hat_bl": mv_hat}
    return planes, dpb


def write_planes(coder, planes) -> bytes:
    """Host half: rANS-encode one BL frame's planes
    (`dmc_net_extend.py:87-92` order)."""
    with spans.span("lssvc.entropy.encode"):
        raise_if_nonfinite("DMC BL encode", planes["finite"])
        coder.reset_encoder()
        coder.encode_factorized(planes["mv_z_hat"], coder.z_mv_table)
        coder.encode_gaussian(planes["mv_y_q"], planes["mv_idx"])
        coder.encode_factorized(planes["z_hat"], coder.z_table)
        coder.encode_gaussian(planes["y_q"], planes["y_idx"])
        return coder.flush()


class DecodeProfilingMixin:
    """Per-stage decode wall-clock averages, the reference's
    `--decoding_profiling` (`dmc_net_extend.py:19-47`), folded from the
    decoder's spans: each stage in DECODING_STAGES is a span named
    SPAN_PREFIX + stage inside the frame's `lssvc.p.decode` span
    (`DecodeFrame`).  The stages follow one another and hold all of the
    decoder's work between the first and the last, so they sum to
    "overall", the seconds from the first stage's start to the last
    one's end (less the microseconds of Python between two spans).  With
    `profile_decoding` set, each stage is bracketed by device
    synchronizes, so its time is its device work; without it, nothing
    synchronises."""

    DECODING_STAGES: tuple = ()
    SPAN_PREFIX = ""

    def _init_decoding_profiling(self):
        self.profile_decoding = False
        self.decoding_profiling = {
            k: 0 for k in ("frames", "overall", *self.DECODING_STAGES)}
        self.stage_spans = {k: self.SPAN_PREFIX + k
                            for k in self.DECODING_STAGES}

    def reset_decoding_profiling(self):
        for k in self.decoding_profiling:
            self.decoding_profiling[k] = 0

    def get_average_decoding_profiling(self):
        frames = max(self.decoding_profiling["frames"], 1)
        return {k: (v if k == "frames" else v / frames)
                for k, v in self.decoding_profiling.items()}


class _Synced:
    """A span bracketed by device synchronizes."""

    def __init__(self, span, device):
        self.span, self.device = span, device

    def __enter__(self):
        _sync(self.device)
        return self.span.__enter__()

    def __exit__(self, *exc):
        _sync(self.device)
        return self.span.__exit__(*exc)


class DecodeFrame:
    """The spans of one decoded P-frame: the frame span `lssvc.p.decode`
    and, through `stage(layer, key)`, each layer's stage spans.  `layers`
    (DecodeProfilingMixin models) are the layers the frame decodes; the
    first one's `profile_decoding` turns the profiling on: then each stage
    is a span kept here, bracketed by device synchronizes, and at the
    frame's end each layer's dict gets its stages' seconds, the stages'
    extent ("overall") and one frame."""

    def __init__(self, *layers):
        self.layers = layers
        self.device = layers[0].device if layers[0].profile_decoding \
            else None
        self.stages = []  # (layer, key, span) while profiling
        self.frame = spans.frame("lssvc.p.decode")

    def __enter__(self):
        self.frame.__enter__()
        return self

    def __exit__(self, *exc):
        self.frame.__exit__(*exc)
        if self.stages and exc[0] is None:
            self._fold()
        return False

    def stage(self, layer, key):
        if self.device is None:
            return spans.span(layer.stage_spans[key])
        span = spans.Span(layer.stage_spans[key])
        self.stages.append((layer, key, span))
        return _Synced(span, self.device)

    def _fold(self):
        overall = (self.stages[-1][2].end_ns
                   - self.stages[0][2].start_ns) * 1e-9
        for layer in self.layers:
            prof = layer.decoding_profiling
            for owner, key, span in self.stages:
                if owner is layer:
                    prof[key] += span.seconds
            prof["overall"] += overall
            prof["frames"] += 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DMCExtend(DecodeProfilingMixin, DMC):
    """The base layer with real bitstreams (`dmc_net_extend.py`)."""

    # the stages dmc_stream's decoder times, as the JAX package names them
    # (spans SPAN_PREFIX + stage)
    SPAN_PREFIX = "lssvc.p.decode.bl."
    DECODING_STAGES = (
        "entropy_dec_mv_z", "mv_y_prior_dec", "entropy_dec_mv_y", "mv_dec",
        "motion_compensation_ctx_refine", "entropy_dec_z", "y_prior",
        "entropy_dec_y", "res_dec")
    # mv_z and z channels
    channel_N = 64

    def __init__(self, params: dict, device="cuda", **mode):
        super().__init__(params, device=device, **mode)
        self._coder = None
        self._init_decoding_profiling()

    def update(self, force=False):
        if self._coder is None or force:
            self._coder = VideoCoder(self.flat_params())

    @scoped
    def encode_planes(self, x, dpb):
        """The device half of `compress`: (planes, dpb), nothing read on
        the host (`models/pipeline.py` writes the planes on a worker)."""
        dpb = sanitize_dpb(dpb)
        return encode_device(self.flat_params(), x, dpb["ref_frame_bl"],
                             dpb["ref_feature_bl"])

    def compress(self, x, dpb):
        planes, out_dpb = self.encode_planes(x, dpb)
        return {"string": write_planes(self._coder, planes), "dpb": out_dpb}

    @scoped
    def decompress(self, string, height, width, dpb):
        dpb = sanitize_dpb(dpb)
        p = P(self.flat_params())
        coder = self._coder
        z_shape = (1, *get_downsampled_shape(height, width, 64),
                   self.channel_N)
        with DecodeFrame(self) as frame:
            with frame.stage(self, "entropy_dec_mv_z"):
                coder.set_stream(string)
                mv_z = coder.decode_factorized(z_shape, coder.z_mv_table,
                                               self.device)
            with frame.stage(self, "mv_y_prior_dec"):
                mv_idx, mv_means = dec_mv_prior(p, mv_z)
            with frame.stage(self, "entropy_dec_mv_y"):
                mv_y_q = coder.decode_gaussian(mv_idx)
            with frame.stage(self, "mv_dec"):
                mv_hat = dec_mv(p, mv_y_q, mv_means)
            with frame.stage(self, "motion_compensation_ctx_refine"):
                c1, c2, c3 = dec_contexts(p, mv_hat, dpb["ref_frame_bl"],
                                          dpb["ref_feature_bl"])
            with frame.stage(self, "entropy_dec_z"):
                z = coder.decode_factorized(z_shape, coder.z_table,
                                            self.device)
            with frame.stage(self, "y_prior"):
                y_idx, y_means = dec_y_prior(p, z, c1, c2, c3)
            with frame.stage(self, "entropy_dec_y"):
                y_q = coder.decode_gaussian(y_idx)
            with frame.stage(self, "res_dec"):
                recon, feature, y_hat = dec_recon(p, y_q, y_means, c1, c2,
                                                  c3)
        return {"dpb": {"ref_frame_bl": recon, "ref_feature_bl": feature,
                        "y_hat_bl": y_hat, "mv_hat_bl": mv_hat}}

    @scoped
    def encode_decode(self, x, dpb, output_path, pic_width, pic_height):
        """Write x's stream to `output_path`, then decode the file: the
        decoded DPB, the file's bits, and the encode and decode seconds."""
        t0 = time.perf_counter()
        encoded = self.compress(x, dpb)
        encode_p(encoded["string"], output_path)
        _sync(self.device)
        t1 = time.perf_counter()
        decoded = self.decompress(decode_p(output_path), pic_height,
                                  pic_width, dpb)
        _sync(self.device)
        t2 = time.perf_counter()
        return {"dpb": decoded["dpb"], "bit": filesize(output_path) * 8,
                "encoding_time": t1 - t0, "decoding_time": t2 - t1}
