"""IntraSS real bitstreams: two .bin files per I-frame, BL first (the JAX
package's `models/intra_ss_stream.py`; reference `IntraSS.py:245-336`).

The BL is an IntraNoAR stream.  The EL's priors come from the *decoded*
BL image and latent, so the decoder reads the BL file, then the EL file.
The encoder is closed-loop throughout: the BL reconstruction and latent
come from `IntraNoAR.compress(with_recon=True)`, the EL's contexts and
prior planes from the decoder's own `context_mining` / `el_prior_planes`,
and the EL y_hat from `intra_noar.y_roundtrip`, so it returns the
decoder's pictures with no rANS decode.  Under latent RDO the encoder
refines the BL latents (`models/rdo.py`) before it codes them; the
decoder does not change.
"""

from __future__ import annotations

import torch

from ..convert import P
from ..entropy.models import build_indexes_img
from ..ops import pad_nhwc
from ..utils import spans
from ..utils.stream import decode_i, encode_i, filesize, get_downsampled_shape
from .intra_noar import y_roundtrip
from .intra_ss import context_mining, el_analysis, el_priors, el_synthesis


def _depad(model, x_hat_bl, y_hat_bl):
    pad = model.pad_size
    return (pad_nhwc(x_hat_bl, pad),
            pad_nhwc(y_hat_bl, tuple(int(v / 16) for v in pad)))


def el_prior_planes(params, z_hat, y_hat_bl, ctx3, shape_hr):
    scales, means = el_priors(params, z_hat, y_hat_bl, ctx3, shape_hr)
    return build_indexes_img(scales), means


def compress_stream(model, x_bl, x_el, bin_path_bl, bin_path_el,
                    pic_height_bl, pic_width_bl, pic_height_el, pic_width_el,
                    rdo=False, rdo_opt=None):
    """Writes both .bin files; returns their bits and the decoder's
    reconstructions (closed loop, see the module docstring).  `rdo`
    refines the BL latents first (options `rdo_opt`).  Runs in the
    model's mode, as the frame span `lssvc.i.encode`."""
    with torch.no_grad(), model.scope(), spans.frame("lssvc.i.encode"):
        return _compress_stream(model, x_bl, x_el, bin_path_bl, bin_path_el,
                                pic_height_bl, pic_width_bl, pic_height_el,
                                pic_width_el, rdo, rdo_opt)


def _compress_stream(model, x_bl, x_el, bin_path_bl, bin_path_el,
                     pic_height_bl, pic_width_bl, pic_height_el,
                     pic_width_el, rdo, rdo_opt):
    model.update()
    bl = model.base_layer_model
    params = model.el_params()
    shape_hr = model.shape_hr

    y_bl, z_bl = (bl.refined_y_z(x_bl, rdo_opt) if rdo
                  else bl.get_y_z(x_bl))
    compressed = bl.compress(y=y_bl, z=z_bl, with_recon=True)
    encode_i(pic_height_bl, pic_width_bl, compressed["strings"][0][0],
             compressed["strings"][1][0], bin_path_bl)
    x_hat_bl, y_hat_bl = _depad(model, compressed["x_hat"],
                                compressed["y_hat"])

    y_el, z_el, _ = el_analysis(params, x_el, x_hat_bl, shape_hr)
    # the contexts of the EL priors come from the decoder's own call
    c1, c2, c3 = context_mining(P(params), x_hat_bl, shape_hr)
    z_strings = model._coder.eb_compress(z_el)
    z_hat = model._coder.eb_decompress(z_strings, z_el.shape[1:3],
                                       model.device)
    idx, means = el_prior_planes(params, z_hat, y_hat_bl, c3, shape_hr)
    y_strings = model._coder.gc_compress(y_el, idx, means)
    encode_i(pic_height_el, pic_width_el, y_strings[0], z_strings[0],
             bin_path_el)

    feature, x_hat_el = el_synthesis(params, y_roundtrip(y_el, means),
                                     c1, c2, c3)
    return {"bit_bl": filesize(bin_path_bl) * 8,
            "bit_el": filesize(bin_path_el) * 8,
            "x_hat_bl": compressed["x_hat"], "x_hat_el": x_hat_el,
            "feature_el": feature}


def decompress_stream(model, bin_path_bl, bin_path_el):
    """Both layers' reconstructions from the two .bin files: the decoder
    half of `IntraSS.encode_decode`, and what the decode CLI runs, in the
    model's mode, as the frame span `lssvc.i.decode`."""
    with torch.no_grad(), model.scope(), spans.frame("lssvc.i.decode"):
        return _decompress_stream(model, bin_path_bl, bin_path_el)


def _decompress_stream(model, bin_path_bl, bin_path_el):
    model.update()
    bl = model.base_layer_model
    params = model.el_params()
    shape_hr = model.shape_hr

    h_bl, w_bl, y_str_bl, z_str_bl = decode_i(bin_path_bl)
    dec_bl = bl.decompress([[y_str_bl], [z_str_bl]],
                           get_downsampled_shape(h_bl, w_bl, 64))
    x_hat_bl, y_hat_bl = _depad(model, dec_bl["x_hat"], dec_bl["y_hat"])

    h_el, w_el, y_str_el, z_str_el = decode_i(bin_path_el)
    c1, c2, c3 = context_mining(P(params), x_hat_bl, shape_hr)
    z_hat = model._coder.eb_decompress(
        [z_str_el], get_downsampled_shape(h_el, w_el, 64), model.device)
    idx, means = el_prior_planes(params, z_hat, y_hat_bl, c3, shape_hr)
    y_hat = model._coder.gc_decompress([y_str_el], idx, means)
    feature, x_hat_el = el_synthesis(params, y_hat, c1, c2, c3)
    return {"x_hat_bl": dec_bl["x_hat"], "x_hat_el": x_hat_el,
            "feature_el": feature}
