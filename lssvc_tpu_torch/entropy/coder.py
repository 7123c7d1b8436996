"""CDF tables and the rANS coder bundles of the stream path (the JAX
package's `entropy/coder.py`).

The `update()`-time builders quantise each probability model into integer
CDFs, bit for bit as the reference does:

  * the video side's factorized BitEstimator, probed over +-50
    (`video_entropy_models.py:168-244`);
  * the video side's Laplace table over 256 log-spaced scales
    (`video_entropy_models.py:247-307`);
  * the image side's EntropyBottleneck (`img_entropy_models.py:436-476`);
  * the image side's Gaussian conditional (`img_entropy_models.py:623-648`).

The factorized tables probe the port's own networks in float32 on the
CPU, whatever device the model runs on.  Symbols go to the coder in
NCHW-flat (channel-major) order, the reference's `.reshape(-1)` of an NCHW
tensor, taken from the port's NHWC tensors.  Each tensor crosses between
the device and the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import P
from ..native import BufferedRansEncoder, RansDecoder, RansEncoder, \
    pmf_to_quantized_cdf
from ..utils.checks import assert_finite_np
from .models import (
    GAUSSIAN_SCALE_TABLE_IMG,
    GAUSSIAN_SCALE_TABLE_VIDEO,
    bit_estimator_forward,
    entropy_bottleneck_logits,
)


class CdfTable:
    """Padded CDF matrix + per-row sizes and symbol offsets."""

    def __init__(self, rows, offsets):
        sizes = np.asarray([len(r) for r in rows], dtype=np.int32)
        mat = np.zeros((len(rows), int(sizes.max())), dtype=np.int32)
        for i, r in enumerate(rows):
            mat[i, :len(r)] = r
        self.cdfs = mat
        self.sizes = sizes
        self.offsets = np.asarray(offsets, dtype=np.int32).reshape(-1)


def _rows_from_pmfs(pmf, tail_mass, pmf_length):
    """Per-row quantized CDFs: row i uses pmf[i, :len_i] + its tail mass."""
    rows = []
    for i in range(pmf.shape[0]):
        prob = np.concatenate([pmf[i, :int(pmf_length[i])],
                               np.atleast_1d(tail_mass[i])]).astype(np.float32)
        rows.append(pmf_to_quantized_cdf(prob, 16))
    return rows


def _laplace_cdf(x, scale):
    return 0.5 - 0.5 * np.sign(x) * np.expm1(-np.abs(x) / scale)


def _cpu_scope(params, prefix: str) -> P:
    """The parameters under `prefix` as float32 CPU tensors."""
    return P({k: v.detach().float().cpu() for k, v in params.items()
              if k.startswith(prefix)}, prefix)


@torch.no_grad()
def build_bit_estimator_table(params, prefix: str) -> CdfTable:
    """Probe the factorized model's support (+-50) and quantize its CDF."""
    p = _cpu_scope(params, prefix)
    channels = p("f1.h").numel()

    def F(samples_c_l):
        # channel on the last axis: (1, 1, L, C)
        x = torch.from_numpy(np.ascontiguousarray(
            samples_c_l.T[None, None], dtype=np.float32))
        return bit_estimator_forward(p, x)[0, 0].numpy().T  # (C, L)

    probe = np.arange(2, 51, dtype=np.float32)
    neg = F(-probe[None, :].repeat(channels, 0))  # F(-i)
    pos = F(probe[None, :].repeat(channels, 0))   # F(+i)

    minima = np.full(channels, 50, dtype=np.int64)
    maxima = np.full(channels, 50, dtype=np.int64)
    for ci in range(channels):
        lo = np.where(neg[ci] < 1e-4)[0]
        if lo.size:
            minima[ci] = int(probe[lo[0]])
        hi = np.where(pos[ci] > 0.9999)[0]
        if hi.size:
            maxima[ci] = int(probe[hi[0]])

    pmf_length = maxima + minima + 1
    samples = (np.arange(int(pmf_length.max()), dtype=np.float32)[None, :]
               - minima[:, None].astype(np.float32))
    lower = F(samples - 0.5)
    upper = F(samples + 0.5)
    pmf = upper - lower
    # the tail's upper bound at the GLOBAL last sample column for every
    # channel, as the reference's `video_entropy_models.py:219`
    # `tail_mass = lower[:, 0, :1] + (1.0 - upper[:, 0, -1:])`: the
    # per-channel support end gives other escape frequencies for channels
    # narrower than the widest one, and bit-exact tables are the contract
    tail_mass = lower[:, 0] + (1.0 - upper[:, -1])
    return CdfTable(_rows_from_pmfs(pmf, tail_mass, pmf_length), -minima)


def build_laplace_table(scale_table=GAUSSIAN_SCALE_TABLE_VIDEO) -> CdfTable:
    """Video-side Laplace table over the 256-entry log scale grid."""
    scales = np.asarray(scale_table, dtype=np.float64)
    probe = np.arange(2, 51, dtype=np.float64)
    # smallest i (probing 2..50) with cdf(i) > 0.9999
    cdf_at = _laplace_cdf(probe[None, :], scales[:, None])
    pmf_center = np.full(scales.shape, 50, dtype=np.int64)
    for si in range(scales.size):
        hit = np.where(cdf_at[si] > 0.9999)[0]
        if hit.size:
            pmf_center[si] = int(probe[hit[0]])
    pmf_length = 2 * pmf_center + 1
    samples = (np.arange(int(pmf_length.max()), dtype=np.float64)[None, :]
               - pmf_center[:, None])
    upper = _laplace_cdf(samples + 0.5, scales[:, None])
    lower = _laplace_cdf(samples - 0.5, scales[:, None])
    pmf = (upper - lower).astype(np.float32)
    tail_mass = 2 * lower[:, 0]
    return CdfTable(_rows_from_pmfs(pmf, tail_mass, pmf_length), -pmf_center)


def build_gaussian_conditional_table(tail_mass: float = 1e-9,
                                     scale_table=GAUSSIAN_SCALE_TABLE_IMG
                                     ) -> CdfTable:
    """Image-side erfc Gaussian table (`img_entropy_models.py:623-648`)."""
    from scipy.special import erfc
    from scipy.stats import norm

    scales = np.asarray(scale_table, dtype=np.float64)
    multiplier = -norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scales * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    samples = np.abs(np.arange(int(pmf_length.max()), dtype=np.float64)[None, :]
                     - pmf_center[:, None])

    def std_cum(v):
        return 0.5 * erfc(-(2 ** -0.5) * v)

    upper = std_cum((0.5 - samples) / scales[:, None])
    lower = std_cum((-0.5 - samples) / scales[:, None])
    pmf = (upper - lower).astype(np.float32)
    tail = 2 * lower[:, 0]
    return CdfTable(_rows_from_pmfs(pmf, tail, pmf_length), -pmf_center)


@torch.no_grad()
def build_entropy_bottleneck_table(params, prefix: str,
                                   filters=(3, 3, 3, 3)) -> CdfTable:
    """Factorized bottleneck table from the quantiles and the logits MLP
    (`img_entropy_models.py:436-476`)."""
    p = _cpu_scope(params, prefix)
    quantiles = p("quantiles").numpy()  # (C, 1, 3)
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64),
                     0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64),
                     0, None)
    pmf_length = maxima + minima + 1
    samples = (np.arange(int(pmf_length.max()), dtype=np.float32)[None, :]
               + (medians - minima)[:, None])

    def logits(v):
        x = torch.from_numpy(np.ascontiguousarray(v[:, None, :],
                                                  dtype=np.float32))
        return entropy_bottleneck_logits(p, x, filters)[:, 0, :].numpy()

    lower = logits(samples - 0.5)
    upper = logits(samples + 0.5)
    sign = -np.sign(lower + upper)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))
    # global last sample column, as `img_entropy_models.py:472`
    # (see build_bit_estimator_table)
    tail_mass = sigmoid(lower[:, 0]) + sigmoid(-upper[:, -1])
    return CdfTable(_rows_from_pmfs(pmf, tail_mass, pmf_length), -minima)


# ---------------------------------------------------------------------------
# symbol order: NHWC tensors <-> NCHW-flat host arrays

def to_symbol_order(x: torch.Tensor) -> np.ndarray:
    """NHWC tensor of integer values (any device) -> flat NCHW-ordered
    int32 host array, in one device-to-host copy."""
    return x.permute(0, 3, 1, 2).to(torch.int32).contiguous().cpu() \
        .numpy().reshape(-1)


def from_symbol_order(flat: np.ndarray, shape_nhwc, device) -> torch.Tensor:
    """Flat NCHW-ordered host array -> float32 NHWC tensor on `device`."""
    n, h, w, c = shape_nhwc
    t = torch.from_numpy(flat).to(device).reshape(n, c, h, w)
    return t.permute(0, 2, 3, 1).float().contiguous()


def channel_indexes(shape_nhwc) -> np.ndarray:
    """Per-element channel index, NCHW-flat order."""
    n, h, w, c = shape_nhwc
    return np.repeat(np.tile(np.arange(c, dtype=np.int32), n), h * w)


class _StreamDecodeMixin:
    """rANS decode methods over `self.decoder` and `self.gaussian_table`;
    the decoded planes land on `device` as float32 NHWC."""

    def decode_factorized(self, shape_nhwc, table: CdfTable,
                          device) -> torch.Tensor:
        vals = self.decoder.decode_stream(channel_indexes(shape_nhwc),
                                          table.cdfs, table.sizes,
                                          table.offsets)
        return from_symbol_order(vals, shape_nhwc, device)

    def decode_gaussian(self, index_nhwc: torch.Tensor) -> torch.Tensor:
        table = self.gaussian_table
        vals = self.decoder.decode_stream(to_symbol_order(index_nhwc),
                                          table.cdfs, table.sizes,
                                          table.offsets)
        return from_symbol_order(vals, index_nhwc.shape, index_nhwc.device)


class StreamDecoder(_StreamDecodeMixin):
    """An independent decode handle over one rANS stream (its own
    RansDecoder state, shared CDF tables)."""

    def __init__(self, gaussian_table: CdfTable, string: bytes):
        self.gaussian_table = gaussian_table
        self.decoder = RansDecoder()
        self.decoder.set_stream(string)


class VideoCoder(_StreamDecodeMixin):
    """The coder bundle of the video models (DMCExtend, LSSVCExtend): two
    factorized tables (z, z_mv) and one shared Laplace table."""

    def __init__(self, params):
        self.z_table = build_bit_estimator_table(params, "bit_estimator_z.")
        self.z_mv_table = build_bit_estimator_table(params,
                                                    "bit_estimator_z_mv.")
        self.gaussian_table = build_laplace_table()
        self.encoder = BufferedRansEncoder()
        self.decoder = RansDecoder()

    def open_stream(self, string: bytes) -> StreamDecoder:
        """An independent decoder over `string` (self.decoder untouched)."""
        return StreamDecoder(self.gaussian_table, string)

    # encode side ------------------------------------------------------------

    def reset_encoder(self):
        self.encoder.reset()

    def encode_factorized(self, x_nhwc: torch.Tensor, table: CdfTable):
        self.encoder.encode_with_indexes(
            to_symbol_order(x_nhwc), channel_indexes(x_nhwc.shape),
            table.cdfs, table.sizes, table.offsets)

    def encode_gaussian(self, y_q_nhwc: torch.Tensor,
                        index_nhwc: torch.Tensor):
        table = self.gaussian_table
        self.encoder.encode_with_indexes(
            to_symbol_order(y_q_nhwc), to_symbol_order(index_nhwc),
            table.cdfs, table.sizes, table.offsets)

    def flush(self) -> bytes:
        return self.encoder.flush()

    # decode side ------------------------------------------------------------

    def set_stream(self, string: bytes):
        self.decoder.set_stream(string)


class IntraCoder:
    """The coder bundle of the intra models (IntraNoAR, the IntraSS EL):
    the EntropyBottleneck table and the image Gaussian conditional table.
    One stream per image of the batch."""

    def __init__(self, params, bottleneck_prefix="entropy_bottleneck."):
        self.eb_table = build_entropy_bottleneck_table(params,
                                                       bottleneck_prefix)
        self.gc_table = build_gaussian_conditional_table()
        self.medians = params[bottleneck_prefix + "quantiles"] \
            .detach().float().cpu().numpy()[:, 0, 1]

    @staticmethod
    def _encode(table, symbols, indexes) -> bytes:
        return RansEncoder().encode_with_indexes(
            symbols, indexes, table.cdfs, table.sizes, table.offsets)

    # EntropyBottleneck ------------------------------------------------------

    def eb_compress(self, z_nhwc: torch.Tensor) -> list:
        # f32 symbol boundary on the host: round(z - median) in numpy
        # float32, which is IEEE as the device's subtract and round are
        z = z_nhwc.detach().float().cpu().numpy()
        assert_finite_np("EntropyBottleneck.compress", z=z)
        symbols = np.round(z - self.medians).astype(np.int32)
        return [self._encode(self.eb_table,
                             symbols[i].transpose(2, 0, 1).reshape(-1),
                             channel_indexes(z[i:i + 1].shape))
                for i in range(z.shape[0])]

    def eb_decompress(self, strings, hw, device) -> torch.Tensor:
        shape = (1, hw[0], hw[1], self.medians.size)
        dec = RansDecoder()
        outs = []
        for s in strings:
            dec.set_stream(s)
            vals = dec.decode_stream(channel_indexes(shape),
                                     self.eb_table.cdfs, self.eb_table.sizes,
                                     self.eb_table.offsets)
            outs.append(vals.reshape(shape[3], *hw).transpose(1, 2, 0))
        # C-contiguous NHWC, as the encoder's tensors: a conv's algorithm,
        # and so its last bits, can depend on its input's strides
        out = np.ascontiguousarray(np.stack(outs), dtype=np.float32)
        return torch.from_numpy(out + self.medians).to(device)

    # GaussianConditional ----------------------------------------------------

    def gc_compress(self, y_nhwc: torch.Tensor, index_nhwc: torch.Tensor,
                    means_nhwc: torch.Tensor) -> list:
        # f32 symbol boundary on the host (see eb_compress): the same round
        # as the closed loop's `intra_noar.y_roundtrip` on the device
        y = y_nhwc.detach().float().cpu().numpy()
        means = means_nhwc.detach().float().cpu().numpy()
        assert_finite_np("GaussianConditional.compress", y=y, means=means)
        symbols = np.round(y - means).astype(np.int32)
        index = index_nhwc.cpu().numpy()
        return [self._encode(self.gc_table,
                             symbols[i].transpose(2, 0, 1).reshape(-1),
                             index[i].transpose(2, 0, 1).reshape(-1))
                for i in range(y.shape[0])]

    def gc_decompress(self, strings, index_nhwc: torch.Tensor,
                      means_nhwc: torch.Tensor) -> torch.Tensor:
        index = index_nhwc.cpu().numpy()
        dec = RansDecoder()
        outs = []
        for i, s in enumerate(strings):
            dec.set_stream(s)
            vals = dec.decode_stream(index[i].transpose(2, 0, 1).reshape(-1),
                                     self.gc_table.cdfs, self.gc_table.sizes,
                                     self.gc_table.offsets)
            outs.append(vals.reshape(index.shape[3], *index.shape[1:3])
                        .transpose(1, 2, 0))
        # C-contiguous NHWC (see eb_decompress)
        y_q = torch.from_numpy(np.ascontiguousarray(np.stack(outs),
                                                    dtype=np.float32))
        return y_q.to(means_nhwc.device) + means_nhwc
