"""Cheng2020Anchor — the autoregressive-context hyperprior image codec (the
JAX package's `models/cheng2020.py`; reference `priors.py:455-799`).

IntraNoAR's transforms plus a masked 5x5 context model (PixelCNN mask A)
whose output joins the hyperprior in a 1x1 entropy-parameter stack.  In
`model_architectures` for the API (the reference wires it into no harness
either).

The estimated-bits forward runs on the device, the masked conv as a plain
conv with a masked kernel.  `compress` / `decompress` are serial: each
latent pixel's distribution depends on the pixels decoded before it, so
the context and the entropy-parameter stack run per pixel on the host in
float32 numpy (no device round trip a pixel), against the port's rANS.
Encoder and decoder run the same host code on the same values, so the
decoder's y_hat equals the encoder's exactly.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..convert import P
from ..entropy.coder import IntraCoder
from ..entropy.models import (
    entropy_bottleneck_forward,
    gaussian_conditional_likelihood,
)
from ..native import BufferedRansEncoder, RansDecoder
from ..ops import conv2d, leaky_relu, ste_round
from ..utils.stream import decode_i, encode_i, filesize, get_downsampled_shape
from .base import Model, scoped
from .components import cat
from .intra_noar import g_a, g_s, h_a, h_s

LOG2 = math.log(2.0)
CTX_PAD = 2  # the 5x5 context kernel's half width


def mask_kernel(w):
    """An OIHW kernel with its "future" taps zeroed (PixelCNN mask A): the
    centre and right of the middle row, and every row below."""
    kh, kw = w.shape[2], w.shape[3]
    mask = torch.ones((1, 1, kh, kw), dtype=w.dtype, device=w.device)
    mask[:, :, kh // 2, kw // 2:] = 0
    mask[:, :, kh // 2 + 1:, :] = 0
    return w * mask


def entropy_parameters(p, x):
    x = leaky_relu(conv2d(x, p("0.weight"), p("0.bias"), padding=0))
    x = leaky_relu(conv2d(x, p("2.weight"), p("2.bias"), padding=0))
    return conv2d(x, p("4.weight"), p("4.bias"), padding=0)


def forward(params, x):
    """Estimated bits (`priors.py:529-551`): x NHWC -> x_hat, y_hat, bit and
    the likelihoods."""
    p = P(params)
    y = g_a(p.sub("g_a"), x)
    z = h_a(p.sub("h_a"), y)
    z_hat, z_lik = entropy_bottleneck_forward(p.sub("entropy_bottleneck"), z)
    hyper = h_s(p.sub("h_s"), z_hat)

    y_hat = ste_round(y)
    ctx_p = conv2d(y_hat, mask_kernel(p("context_prediction.weight")),
                   p("context_prediction.bias"), padding=CTX_PAD)
    gaussian_params = entropy_parameters(p.sub("entropy_parameters"),
                                         cat([hyper, ctx_p]))
    half = gaussian_params.shape[-1] // 2
    scales_hat = gaussian_params[..., :half]
    means_hat = gaussian_params[..., half:]
    # the likelihood at round(y - means) + means (the reference's
    # `gaussian_conditional(y, scales, means=means_hat)`, eval mode
    # "dequantize", `priors.py:545`); round(y) feeds only the context model
    # and g_s
    y_q = ste_round(y - means_hat) + means_hat
    y_lik = gaussian_conditional_likelihood(y_q, scales_hat, means_hat)
    x_hat = g_s(p.sub("g_s"), y_hat)
    bit = (torch.sum(torch.log(y_lik)) + torch.sum(torch.log(z_lik))) / (-LOG2)
    return {"x_hat": x_hat, "y_hat": y_hat, "bit": bit,
            "likelihoods": {"y": y_lik, "z": z_lik}}


def _indexes_np(scales):
    """The host's `entropy.models.build_indexes_img`, with the reference's
    +1 bias, in float32."""
    log_min = math.log(0.11)
    step = (math.log(256.0) - log_min) / (64 - 1)
    idx = (np.log(np.maximum(scales, 1e-5)) - log_min) / step + 1
    return np.clip(idx, 0, 63).astype(np.int32)


def _pixel_params(w, y_hat_pad, hyper_vec, i, j):
    """(scale indexes, means) of latent pixel (i, j) from the decoded
    pixels before it (`y_hat_pad`, the latent padded by CTX_PAD) and its
    hyperprior vector; the one host computation of encoder and decoder."""
    crop = y_hat_pad[i:i + 2 * CTX_PAD + 1, j:j + 2 * CTX_PAD + 1, :]
    v = np.concatenate(
        [hyper_vec, np.einsum("hwc,hwcd->d", crop, w["ctx_w"]) + w["ctx_b"]])
    for k, (wk, bk) in enumerate(w["ep"]):
        v = v @ wk + bk
        if k < 2:
            v = np.where(v >= 0, v, 0.01 * v)
    half = v.shape[0] // 2
    return _indexes_np(v[:half]), v[half:]


class Cheng2020Anchor(Model):
    """The codec on `device` (default "cuda"; raises without CUDA unless
    "cpu" is asked for), N from the weights.  Only the reference's leaky
    ReLU slope of 0.01 is taken: the forward and the host's per-pixel stack
    both use it, and another slope would decode a checkpoint trained with
    it with the wrong activations."""

    def __init__(self, params: dict, device="cuda", precision="fp32",
                 leaky_relu_slope=0.01):
        if abs(float(leaky_relu_slope) - 0.01) > 1e-12:
            raise NotImplementedError(
                "Cheng2020Anchor supports leaky_relu_slope=0.01 only")
        super().__init__(params, device=device, precision=precision)
        # g_s.0.conv1 is an OIHW (N, N, 3, 3) weight
        self.N = int(params["g_s.0.conv1.weight"].shape[0])
        self._coder = None  # built by update()

    @scoped
    def forward(self, x):
        return forward(self.flat_params(), x)

    @scoped
    def get_rec_only(self, x):
        """g_a -> round -> g_s only (`priors.py:553-561`), no entropy
        model."""
        p = P(self.flat_params())
        y_hat = ste_round(g_a(p.sub("g_a"), x))
        return {"x_hat": g_s(p.sub("g_s"), y_hat), "y_hat": y_hat}

    @scoped
    def encode_decode(self, x, output_path=None, pic_width=None,
                      pic_height=None, rdo=False, rdo_opt=None):
        """Without `output_path`: the estimated bits and x_hat.  With it:
        write x's stream there, then decode the file.  Latent RDO is not
        supported here (`rdo` warns and is ignored)."""
        if rdo:
            warnings.warn("RDO is not supported for Cheng2020Anchor.")
        if output_path is None:
            out = self.forward(x)
            return {"bit": float(out["bit"]), "x_hat": out["x_hat"]}
        compressed = self.compress(x=x)
        encode_i(pic_height, pic_width, compressed["strings"][0][0],
                 compressed["strings"][1][0], output_path)
        height, width, y_string, z_string = decode_i(output_path)
        dec = self.decompress([[y_string], [z_string]],
                              get_downsampled_shape(height, width, 64))
        return {"bit": filesize(output_path) * 8, "x_hat": dec["x_hat"]}

    def update(self, force=False):
        """Build the CDF tables (once, or again with `force`)."""
        if self._coder is None or force:
            self._coder = IntraCoder(self.flat_params())

    # -- serial autoregressive coding (host side) -----------------------------

    def _host_weights(self):
        """The context and entropy-parameter weights as float32 numpy: the
        masked context kernel HWIO (5, 5, N, 2N), each 1x1 conv as an
        (in, out) matrix."""
        p = self.flat_params()

        def host(t):
            return t.detach().float().cpu().numpy()

        return {
            "ctx_w": host(mask_kernel(p["context_prediction.weight"])
                          .permute(2, 3, 1, 0)),
            "ctx_b": host(p["context_prediction.bias"]),
            "ep": [(np.ascontiguousarray(
                        host(p[f"entropy_parameters.{i}.weight"])[:, :, 0, 0].T),
                    host(p[f"entropy_parameters.{i}.bias"]))
                   for i in (0, 2, 4)],
        }

    def _hyper(self, z_hat):
        return h_s(P(self.flat_params()).sub("h_s"), z_hat) \
            .float().cpu().numpy()

    @scoped
    def compress(self, x=None, y=None, z=None):
        """rANS-encode (y, z) (or x's) -> {"strings": [y_strings,
        z_strings], "shape": z's (h, w), "y_hat": the latents the decoder
        rebuilds, (n, h, w, N) float32 numpy}."""
        p = P(self.flat_params())
        if x is not None:
            y = g_a(p.sub("g_a"), x)
            z = h_a(p.sub("h_a"), y)
        hw = (z.shape[1], z.shape[2])
        z_strings = self._coder.eb_compress(z)
        hyper = self._hyper(self._coder.eb_decompress(z_strings, hw,
                                                      self.device))
        w = self._host_weights()
        y_np = y.float().cpu().numpy()
        n, yh, yw, c = y_np.shape
        gc = self._coder.gc_table
        y_strings, y_hats = [], []
        for b in range(n):
            y_hat = np.zeros((yh + 2 * CTX_PAD, yw + 2 * CTX_PAD, c),
                             np.float32)
            syms, idxs = [], []
            for i in range(yh):
                for j in range(yw):
                    idx, means = _pixel_params(w, y_hat, hyper[b, i, j], i, j)
                    q = np.round(y_np[b, i, j] - means)
                    y_hat[i + CTX_PAD, j + CTX_PAD] = q + means
                    syms.append(q.astype(np.int32))
                    idxs.append(idx)
            enc = BufferedRansEncoder()
            enc.encode_with_indexes(np.concatenate(syms),
                                    np.concatenate(idxs), gc.cdfs, gc.sizes,
                                    gc.offsets)
            y_strings.append(enc.flush())
            y_hats.append(y_hat[CTX_PAD:-CTX_PAD, CTX_PAD:-CTX_PAD])
        return {"strings": [y_strings, z_strings], "shape": hw,
                "y_hat": np.stack(y_hats)}

    @scoped
    def decompress(self, strings, shape):
        """{"x_hat" clamped to [0, 1], "y_hat"}, both on the device, from
        `compress`'s strings and z's (h, w)."""
        hyper = self._hyper(self._coder.eb_decompress(strings[1], shape,
                                                      self.device))
        w = self._host_weights()
        yh, yw = shape[0] * 4, shape[1] * 4
        gc = self._coder.gc_table
        outs = []
        for b, stream in enumerate(strings[0]):
            dec = RansDecoder()
            dec.set_stream(stream)
            y_hat = np.zeros((yh + 2 * CTX_PAD, yw + 2 * CTX_PAD, self.N),
                             np.float32)
            for i in range(yh):
                for j in range(yw):
                    idx, means = _pixel_params(w, y_hat, hyper[b, i, j], i, j)
                    q = dec.decode_stream(idx, gc.cdfs, gc.sizes, gc.offsets)
                    y_hat[i + CTX_PAD, j + CTX_PAD] = q + means
            outs.append(y_hat[CTX_PAD:-CTX_PAD, CTX_PAD:-CTX_PAD])
        y_hat = torch.from_numpy(np.ascontiguousarray(np.stack(outs))) \
            .to(self.device)
        x_hat = torch.clamp(g_s(P(self.flat_params()).sub("g_s"), y_hat),
                            0.0, 1.0)
        return {"x_hat": x_hat, "y_hat": y_hat}
