"""IntraNoAR — the hyperprior intra codec of the base layer (the JAX
package's `models/intra_noar.py`): estimated bits (`forward`) and real
bitstreams (`update` / `compress` / `decompress` / `encode_decode`), each
optionally from latents refined by latent RDO (`encode_decode(rdo=True)`,
`models/rdo.py`).

A Cheng-style residual-block hyperprior autoencoder at N=192, with a
factorized EntropyBottleneck on z and a Gaussian conditional on y
(reference `priors.py:112-452`).  Plain PyTorch: the JAX package runs it
as XLA and reaches no Pallas kernel.

The stream encoder is closed-loop: its scale-index and means planes come
from `hyper_params` on the z_hat that `eb_decompress` rebuilds from the
stream, and its y_hat from `y_roundtrip`, the value `gc_decompress`
rebuilds, so `compress(with_recon=True)` returns the decoder's pictures.
"""

from __future__ import annotations

import math

import torch

from ..convert import P
from ..entropy.coder import IntraCoder
from ..entropy.models import (
    build_indexes_img,
    entropy_bottleneck_forward,
    gaussian_conditional_likelihood,
)
from ..ops import leaky_relu, ste_round
from ..utils.stream import decode_i, encode_i, filesize, get_downsampled_shape
from .base import Model, scoped
from .components import (
    conv,
    residual_block,
    residual_block_upsample,
    residual_block_with_stride,
    subpel_conv,
)

LOG2 = math.log(2.0)


def g_a(p, x):
    x = residual_block_with_stride(p.sub("0"), x)
    x = residual_block(p.sub("1"), x)
    x = residual_block_with_stride(p.sub("2"), x)
    x = residual_block(p.sub("3"), x)
    x = residual_block_with_stride(p.sub("4"), x)
    x = residual_block(p.sub("5"), x)
    return conv(p.sub("6"), x, stride=2)


def h_a(p, y):
    x = leaky_relu(conv(p.sub("0"), y))
    x = leaky_relu(conv(p.sub("2"), x))
    x = leaky_relu(conv(p.sub("4"), x, stride=2))
    x = leaky_relu(conv(p.sub("6"), x))
    return conv(p.sub("8"), x, stride=2)


def h_s(p, z_hat):
    x = leaky_relu(conv(p.sub("0"), z_hat))
    x = leaky_relu(subpel_conv(p.sub("2"), x, 2))
    x = leaky_relu(conv(p.sub("4"), x))
    x = leaky_relu(subpel_conv(p.sub("6"), x, 2))
    return conv(p.sub("8"), x)


def g_s(p, y_hat):
    x = residual_block(p.sub("0"), y_hat)
    x = residual_block_upsample(p.sub("1"), x)
    x = residual_block(p.sub("2"), x)
    x = residual_block_upsample(p.sub("3"), x)
    x = residual_block(p.sub("4"), x)
    x = residual_block_upsample(p.sub("5"), x)
    x = residual_block(p.sub("6"), x)
    return subpel_conv(p.sub("7"), x, 2)


def analysis(params, x):
    """x NHWC -> (y, z)."""
    p = P(params)
    y = g_a(p.sub("g_a"), x)
    z = h_a(p.sub("h_a"), y)
    return y, z


def hyper_params(params, z_hat):
    """z_hat -> (scales, means) of the Gaussian conditional."""
    gaussian_params = h_s(P(params).sub("h_s"), z_hat)
    n_half = gaussian_params.shape[-1] // 2
    return gaussian_params[..., :n_half], gaussian_params[..., n_half:]


def hyper_synthesis_quantize(params, y, z):
    """EntropyBottleneck round trip, then the Gaussian conditional's
    quantisation.  Returns (y_hat, z_hat, y_likelihoods, z_likelihoods,
    scales, means)."""
    z_hat, z_lik = entropy_bottleneck_forward(
        P(params).sub("entropy_bottleneck"), z)
    scales_hat, means_hat = hyper_params(params, z_hat)
    y_hat = ste_round(y - means_hat) + means_hat
    y_lik = gaussian_conditional_likelihood(y_hat, scales_hat, means_hat)
    return y_hat, z_hat, y_lik, z_lik, scales_hat, means_hat


def forward(params, x):
    """Eval forward with estimated bits: x_hat, y_hat, bits and the
    intermediates."""
    y, z = analysis(params, x)
    y_hat, z_hat, y_lik, z_lik, scales_hat, means_hat = \
        hyper_synthesis_quantize(params, y, z)
    x_hat = g_s(P(params).sub("g_s"), y_hat)
    bits = (torch.sum(torch.log(y_lik))
            + torch.sum(torch.log(z_lik))) / (-LOG2)
    return {
        "x_hat": x_hat,
        "y_hat": y_hat,
        "y": y,
        "z": z,
        "z_hat": z_hat,
        "scales_hat": scales_hat,
        "means_hat": means_hat,
        "bit": bits,
    }


def recon_from_yz(params, y, z):
    """The estimated path from given latents (refined ones under RDO; from
    the analysis latents it is `forward`): x_hat, y_hat and the estimated
    bits."""
    y_hat, _, y_lik, z_lik, _, _ = hyper_synthesis_quantize(params, y, z)
    x_hat = g_s(P(params).sub("g_s"), y_hat)
    bits = (torch.sum(torch.log(y_lik))
            + torch.sum(torch.log(z_lik))) / (-LOG2)
    return {"x_hat": x_hat, "y_hat": y_hat, "bit": bits}


def y_roundtrip(y, means):
    """The decoder's y_hat: round(y - means) as int32, plus means, in f32
    (what `IntraCoder.gc_decompress` rebuilds)."""
    sym = torch.round(y.float() - means.float()).to(torch.int32)
    return sym.float() + means.float()


class IntraNoAR(Model):
    """Base-layer I-frame codec on `device` (default "cuda"; raises without
    CUDA unless "cpu" is asked for)."""

    def __init__(self, params: dict, device="cuda", precision="fp32"):
        super().__init__(params, device=device, precision=precision)
        # g_s.0.conv1 is an OIHW (N, N, 3, 3) weight
        self.N = int(params["g_s.0.conv1.weight"].shape[0])
        self._coder = None  # built by update()

    @scoped
    def forward(self, x):
        return forward(self.flat_params(), x)

    def get_layer_information(self, x):
        """BL information for IntraSS's conditioning (`priors.py:368-388`)."""
        out = self.forward(x)
        pixel_num = x.shape[0] * x.shape[1] * x.shape[2]
        return {
            "bits": out["bit"],
            "mse": torch.mean(torch.square(x - out["x_hat"])),
            "bpp": out["bit"] / pixel_num,
            "x_hat": out["x_hat"],
            "y_hat": out["y_hat"],
        }

    # -- real bitstreams ------------------------------------------------------

    def update(self, force=False):
        """Build the CDF tables (once, or again with `force`)."""
        if self._coder is None or force:
            self._coder = IntraCoder(self.flat_params())

    @scoped
    def get_y_z(self, x):
        return analysis(self.flat_params(), x)

    @scoped
    def compress(self, x=None, y=None, z=None, with_recon=False):
        """rANS-encode (y, z) -> {"strings": [y_strings, z_strings],
        "shape": z's (h, w)} (`priors.py:420-437`).  With `with_recon`, also
        the decoder's "x_hat" and "y_hat" (closed loop, see the module
        docstring), with no rANS decode of y."""
        if x is not None:
            y, z = self.get_y_z(x)
        params = self.flat_params()
        z_strings = self._coder.eb_compress(z)
        hw = (z.shape[1], z.shape[2])
        z_hat = self._coder.eb_decompress(z_strings, hw, self.device)
        scales_hat, means_hat = hyper_params(params, z_hat)
        y_strings = self._coder.gc_compress(y, build_indexes_img(scales_hat),
                                            means_hat)
        out = {"strings": [y_strings, z_strings], "shape": hw}
        if with_recon:
            out["y_hat"] = y_roundtrip(y, means_hat)
            out["x_hat"] = g_s(P(params).sub("g_s"), out["y_hat"])
        return out

    @scoped
    def decompress(self, strings, shape):
        params = self.flat_params()
        z_hat = self._coder.eb_decompress(strings[1], shape, self.device)
        scales_hat, means_hat = hyper_params(params, z_hat)
        y_hat = self._coder.gc_decompress(
            strings[0], build_indexes_img(scales_hat), means_hat)
        return {"x_hat": g_s(P(params).sub("g_s"), y_hat), "y_hat": y_hat}

    @scoped
    def refined_y_z(self, x, rdo_opt=None):
        """x's analysis latents refined by latent RDO against x
        (`models/rdo.py` `global_rdo`, options `rdo_opt`)."""
        from .rdo import global_rdo  # rdo.py imports this module

        y, z = analysis(self.flat_params(), x)
        return global_rdo(self.flat_params(), y, z, x, rdo_opt)

    @scoped
    def encode_decode(self, x, output_path=None, pic_width=None,
                      pic_height=None, rdo=False, rdo_opt=None):
        """Code x, from latents refined by latent RDO with `rdo`.  Without
        `output_path`: the estimated bits, x_hat and y_hat.  With it:
        write x's stream there, then decode the file: the decoded x_hat and
        y_hat, and the file's bits."""
        y, z = self.refined_y_z(x, rdo_opt) if rdo else self.get_y_z(x)
        if output_path is None:
            out = recon_from_yz(self.flat_params(), y, z)
            return {"bit": float(out["bit"]), "x_hat": out["x_hat"],
                    "y_hat": out["y_hat"]}
        compressed = self.compress(y=y, z=z)
        encode_i(pic_height, pic_width, compressed["strings"][0][0],
                 compressed["strings"][1][0], output_path)
        height, width, y_string, z_string = decode_i(output_path)
        dec = self.decompress([[y_string], [z_string]],
                              get_downsampled_shape(height, width, 64))
        return {"bit": filesize(output_path) * 8, "x_hat": dec["x_hat"],
                "y_hat": dec["y_hat"]}
