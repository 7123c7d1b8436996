"""IntraSS — the spatially scalable intra codec (the JAX package's
`models/intra_ss.py`): the base layer is IntraNoAR,
and the enhancement layer codes the high-resolution frame conditioned on

  (a) multi-scale texture contexts mined from the decoded BL image, and
  (b) a layer prior resampled from the BL latent, fused with the EL
      hyperprior (reference `IntraSS.py:74-336`).

Estimated bits here (`forward`); real bitstreams in `intra_ss_stream.py`
(`update`, `encode_decode`).  Plain PyTorch: the JAX package runs it as
XLA and reaches no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..convert import P
from ..entropy.coder import IntraCoder
from ..entropy.models import (
    entropy_bottleneck_forward,
    gaussian_conditional_likelihood,
)
from ..ops import bilinear_resize, leaky_relu, pad_nhwc, ste_round
from . import intra_noar
from .base import Model, scoped
from .components import (
    cat,
    conv,
    feature_extractor_3scale,
    gdn_res_decoder,
    gdn_res_encoder,
    multi_scale_context_fusion,
    recon_generation_simple,
    subpel_conv,
)

LOG2 = math.log(2.0)
BL_PREFIX = "base_layer_model."


def texture_resampler(p, x, shape_hr):
    """conv/leaky/conv, then bilinear to the EL grid (`layers.py:258-270`)."""
    f = conv(p.sub("conv_adaptor.0"), x)
    f = leaky_relu(f, 0.01)
    f = conv(p.sub("conv_adaptor.2"), f)
    return bilinear_resize(f, shape_hr)


def layer_prior_resampler(p, y_hat_bl, shape_hr):
    """BL latent -> the EL latent grid (`layers.py:273-285`)."""
    f = conv(p.sub("conv_adaptor.0"), y_hat_bl)
    f = leaky_relu(f, 0.01)
    f = conv(p.sub("conv_adaptor.2"), f)
    return bilinear_resize(f, (shape_hr[0] // 16, shape_hr[1] // 16))


def prior_fusion(p, hyper_prior, layer_prior, context):
    """Fuse the hyper and layer priors with a strided context branch
    (`layers.py:473-492`)."""
    cp = conv(p.sub("context_parameters.0"), context, stride=2)
    cp = leaky_relu(cp, 0.1)
    cp = conv(p.sub("context_parameters.2"), cp, stride=2)
    f = cat([hyper_prior, layer_prior, cp])
    f = leaky_relu(conv(p.sub("params_net.0"), f), 0.01)
    f = leaky_relu(conv(p.sub("params_net.2"), f), 0.01)
    return conv(p.sub("params_net.4"), f)


def h_a(p, y):
    x = leaky_relu(conv(p.sub("0"), y), 0.01)
    x = leaky_relu(conv(p.sub("2"), x, stride=2), 0.01)
    return conv(p.sub("4"), x, stride=2)


def h_s(p, z_hat):
    x = leaky_relu(subpel_conv(p.sub("0"), z_hat, 2), 0.01)
    x = leaky_relu(subpel_conv(p.sub("2"), x, 2), 0.01)
    return conv(p.sub("4"), x)


def context_mining(p, x_bl_hat, shape_hr):
    """Decoded BL image -> the EL's three context scales
    (`IntraSS.py:119-122`)."""
    texture = texture_resampler(p.sub("texture_resampler"), x_bl_hat, shape_hr)
    t1, t2, t3 = feature_extractor_3scale(p.sub("texture_extractor"), texture)
    return multi_scale_context_fusion(p.sub("context_fusion_net"), t1, t2, t3)


def el_analysis(params, x_el, x_bl_hat, shape_hr):
    p = P(params)
    c1, c2, c3 = context_mining(p, x_bl_hat, shape_hr)
    y = gdn_res_encoder(p.sub("g_a"), x_el, c1, c2, c3)
    z = h_a(p.sub("h_a"), y)
    return y, z, (c1, c2, c3)


def el_priors(params, z_hat, y_hat_bl, ctx3, shape_hr):
    """Hyper and layer prior fusion -> (scales, means)."""
    p = P(params)
    hyper_prior = h_s(p.sub("h_s"), z_hat)
    layer_prior = layer_prior_resampler(p.sub("layer_prior_resampler"),
                                        y_hat_bl, shape_hr)
    params_out = prior_fusion(p.sub("prior_fusion_net"), hyper_prior,
                              layer_prior, ctx3)
    n_half = params_out.shape[-1] // 2
    return params_out[..., :n_half], params_out[..., n_half:]


def el_synthesis(params, y_hat, c1, c2, c3):
    p = P(params)
    res_hat = gdn_res_decoder(p.sub("g_s"), y_hat, c2, c3)
    feature, x_hat = recon_generation_simple(p.sub("recon_net"), res_hat, c1)
    return feature, x_hat


def _el_forward(params, x_el, bl_x_hat, bl_y_hat, bl_bit, shape_hr, pad_size):
    """The EL with estimated bits.  `pad_size` is applied as it is
    (negative entries crop: reference `get_depadded_feature`,
    `IntraSS.py:124-135`); the BL latent takes it over 16, truncated."""
    x_bl_hat = pad_nhwc(bl_x_hat, pad_size)
    y_hat_bl = pad_nhwc(bl_y_hat, tuple(int(v / 16) for v in pad_size))

    y, z, (c1, c2, c3) = el_analysis(params, x_el, x_bl_hat, shape_hr)
    z_hat, z_lik = entropy_bottleneck_forward(
        P(params).sub("entropy_bottleneck"), z)
    scales_hat, means_hat = el_priors(params, z_hat, y_hat_bl, c3, shape_hr)
    y_hat = ste_round(y - means_hat) + means_hat
    y_lik = gaussian_conditional_likelihood(y_hat, scales_hat, means_hat)
    feature, x_hat = el_synthesis(params, y_hat, c1, c2, c3)
    bit_el = (torch.sum(torch.log(y_lik)) + torch.sum(torch.log(z_lik))) / (-LOG2)
    return {
        "bit_bl": bl_bit,
        "bit_el": bit_el,
        "x_hat_bl": bl_x_hat,
        "x_hat_el": x_hat,
        "feature_el": feature,
        "y_hat_el": y_hat,
    }


def forward(params, bl_params, x_bl, x_el, shape_hr, pad_size):
    """Two-layer forward with estimated bits (`IntraSS.py:137-172`):
    `params` holds the EL's keys, `bl_params` the IntraNoAR's."""
    bl = intra_noar.forward(bl_params, x_bl)
    return _el_forward(params, x_el, bl["x_hat"], bl["y_hat"], bl["bit"],
                       shape_hr, pad_size)


class IntraSS(Model):
    """Two-layer I-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for).  The `base_layer_model.` keys form
    the submodule `base_layer_model`, an IntraNoAR, so `state_dict()` has
    the reference's keys.  Every width comes from the weights.  Both
    layers run in `precision` (`models/base.py`).  `packed_width` 2 packs
    the EL's shared components (`feature_extractor_3scale`,
    `multi_scale_context_fusion`, `recon_generation_simple`), as the JAX
    package's global packed width does under `--precision int8`; their
    keys differ from the video model's in channel widths, so they find no
    scale in its table and run the bf16 path, packed."""

    def __init__(self, params: dict, device="cuda", precision="fp32",
                 packed_width=1, int8_table=None):
        super().__init__({k: v for k, v in params.items()
                          if not k.startswith(BL_PREFIX)}, device=device,
                         precision=precision, packed_width=packed_width,
                         int8_table=int8_table)
        self.base_layer_model = intra_noar.IntraNoAR(
            {k[len(BL_PREFIX):]: v for k, v in params.items()
             if k.startswith(BL_PREFIX)}, device=device, precision=precision)
        self.base_layer_model.share_int8(self)
        self.shape_hr = (256, 256)
        self.pad_size = (0, 0, 0, 0)
        self._coder = None  # the EL's, built by update()

    def set_scale_information(self, scale, shape_hr, pad_size):
        """The video model's signature; the EL's grid is `shape_hr`, so
        `scale` is not read."""
        self.shape_hr = tuple(int(v) for v in shape_hr)
        self.pad_size = tuple(int(v) for v in pad_size)

    def el_params(self) -> dict:
        return {k: v for k, v in self.named_parameters()
                if not k.startswith(BL_PREFIX)}

    @scoped
    def forward(self, x_bl, x_el, rdo=False):
        if rdo:
            raise NotImplementedError(
                "latent RDO on the base layer (models/rdo.py) is not ported")
        return forward(self.el_params(), self.base_layer_model.flat_params(),
                       x_bl, x_el, self.shape_hr, self.pad_size)

    def update(self, force=False):
        """Build both layers' CDF tables (once, or again with `force`)."""
        if self._coder is None or force:
            self._coder = IntraCoder(self.el_params())
            self.base_layer_model.update(force=force)

    @scoped
    def encode_decode(self, x_bl, x_el, bin_path_bl, bin_path_el,
                      pic_height_bl, pic_width_bl, pic_height_el,
                      pic_width_el):
        """Write the BL and EL streams, then decode both files: bits from
        the file sizes, and the decoded pictures."""
        from .intra_ss_stream import compress_stream, decompress_stream

        enc = compress_stream(self, x_bl, x_el, bin_path_bl, bin_path_el,
                              pic_height_bl, pic_width_bl, pic_height_el,
                              pic_width_el)
        dec = decompress_stream(self, bin_path_bl, bin_path_el)
        return dict(dec, bit_bl=enc["bit_bl"], bit_el=enc["bit_el"])
