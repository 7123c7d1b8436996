"""Integer (int8) convolution of the int8 serving precision (the JAX
package's `lssvc_tpu/ops/int8.py`).

Quantization scheme (symmetric post-training quantization, as there):
  x_q = clip(round(x / s_x), -127, 127)        (per-tensor activation)
  w_q = clip(round(w / s_w[o]), -127, 127)     (per output channel)
  y   = conv(x_q, w_q) in s32, dequantized by s_x * s_w[o] (+ bias), or
        requantized to the next layer's s8 with a fused multiplier.

`int8_conv2d` is the s8 x s8 -> s32 convolution: for CUDA tensors the
hand-written kernel of `csrc/int8_conv.cu` (built at first use, see
build.py), for CPU tensors its plain version `int8_conv2d_plain`, an exact
integer convolution (float64 products and sums of s8 values, exact below
2^53).  A
CUDA tensor launches the kernel or raises.  With `s_in` the kernel takes a
bf16 or f32 input and quantizes it as it loads it; with `mult` and `bias`
it returns the calibrated site's epilogue in bf16,
bf16(f32(acc) * mult + bias).  Launches are counted in
`int8_conv2d.launches`.

Divisions here divide by a tensor on the dividend's device: PyTorch's CUDA
division by a Python number multiplies by its reciprocal, which is not the
IEEE quotient that jnp and the kernel compute.

The serving state of a model (the JAX package's module globals `_CALIB`,
`_SERVED` and `_RECORDING`, `ops/int8.py:179-264`) is an `Int8Sites`, held
in the model's `ops.nn.Mode`: the calibration table, the sites served from
it, and the absmax recorder of a calibration run.  Weights are OIHW here;
a site's calibration key is the JAX package's, the scope prefix plus the
unpacked kernel's `Cin x Cout`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import build
from . import spatial_ctx, strips

CIN_ALIGN = 32  # the kernel's K step: one wgmma m64nNk32 s8
# the kernel's Cout chunks (the N of one wgmma), narrowest first; a Cout
# past the widest runs in several chunks of it
CHUNK_NS = (16, 32, 64, 96, 128)
# float64 elements of the plain version's im2col in one band of rows (2 GiB)
PLAIN_BAND = 1 << 28
_IN_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("int8_conv")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        args = [vp, vp, vp, vp, vp, ctypes.c_float, *([i32] * 16)]
        lib.lssvc_int8_conv.argtypes = [*args, vp]
        lib.lssvc_int8_conv.restype = i32
        lib.lssvc_int8_plan.argtypes = [*args, ctypes.POINTER(i32)]
        lib.lssvc_int8_plan.restype = i32
        _LIB = lib
    return _LIB


def f32_scalar(value, device) -> torch.Tensor:
    """A Python number as a 0-d f32 tensor on `device` (rounded to f32 as
    `jnp.float32(value)` rounds it)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def quant_act(x, scale) -> torch.Tensor:
    """Symmetric per-tensor activation quantization -> int8."""
    q = torch.round(x.float() / f32_scalar(scale, x.device))
    return q.clamp_(-127, 127).to(torch.int8)


def calib_act_scale(x, pct=99.9) -> float:
    """Host-side calibration: percentile absmax -> scale."""
    a = np.abs(np.asarray(x, np.float32)).reshape(-1)
    amax = np.percentile(a, pct) if a.size else 1.0
    return float(max(amax, 1e-8) / 127.0)


def quant_weight(w):
    """Per-output-channel symmetric weight quantization of an OIHW kernel
    (a depthwise (C, 1, kh, kw) one too).  Returns (w_q int8 OIHW,
    scale (O,) f32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=(1, 2, 3))
    scale = amax.clamp_min(1e-8) / f32_scalar(127.0, w.device)
    q = torch.round(wf / scale.view(-1, 1, 1, 1))
    return q.clamp_(-127, 127).to(torch.int8), scale


def chunk_n(cout: int) -> int:
    """The kernel's Cout chunk for a Cout (`chunk_n` of csrc/int8_conv.cu):
    the narrowest of `CHUNK_NS` that holds it, else the widest."""
    return next((n for n in CHUNK_NS if cout <= n), CHUNK_NS[-1])


def _padding(kh, kw, padding):
    """JAX-style padding -> ((top, bottom), (left, right))."""
    if padding is None:
        padding = ((kh - 1) // 2, (kw - 1) // 2)
    if isinstance(padding, int):
        padding = (padding, padding)
    if isinstance(padding[0], int):
        padding = ((padding[0], padding[0]), (padding[1], padding[1]))
    return tuple(tuple(int(v) for v in p) for p in padding)


class Int8Weight:
    """An s8 OIHW kernel, and for a calibrated site its epilogue: `mult`
    (Cout,) f32, the dequantizing multiplier s_in * w_scale, and `bias`
    (Cout,) f32.  `layout()` is the kernel's copy, built once on the
    weight's device: B of wgmma in its K-major core-matrix layout without
    swizzle, (cout_pad / N, kh*kw, cinp / 16, N, 16) s8, N = `chunk_n`
    (Cout), Cin padded with zeros to `cinp` (a multiple of 32) and Cout to
    `cout_pad` (a multiple of N).  Element [j, ky*kw + kx, c, o, i] is
    w[j*N + o, 16*c + i, ky, kx]: Cout chunks outermost, then taps, so one
    tap of a chunk (or a run of taps) is one contiguous copy."""

    def __init__(self, w_q: torch.Tensor, mult=None, bias=None):
        if w_q.dtype != torch.int8 or w_q.dim() != 4:
            raise TypeError(f"an s8 OIHW kernel, got {w_q.dtype} "
                            f"{tuple(w_q.shape)}")
        if (mult is None) != (bias is None):
            raise ValueError("mult and bias come together")
        self.w_q = w_q.contiguous()
        self.mult = None if mult is None else mult.float().contiguous()
        self.bias = None if bias is None else bias.float().contiguous()
        cout, cin = self.w_q.shape[:2]
        self.n_chunk = chunk_n(cout)
        self.cout_pad = -(-cout // self.n_chunk) * self.n_chunk
        self.cinp = -(-cin // CIN_ALIGN) * CIN_ALIGN
        self._layout = None

    def layout(self) -> torch.Tensor:
        if self._layout is None:
            cout, cin, kh, kw = self.w_q.shape
            n = self.n_chunk
            pad = self.w_q.new_zeros((self.cout_pad, self.cinp, kh, kw))
            pad[:cout, :cin] = self.w_q
            self._layout = pad.view(
                self.cout_pad // n, n, self.cinp // 16, 16, kh, kw).permute(
                0, 4, 5, 2, 1, 3).reshape(
                self.cout_pad // n, kh * kw, self.cinp // 16, n, 16) \
                .contiguous()
        return self._layout


def int8_conv2d_plain(x, w, stride=1, padding=None, s_in=None, mult=None,
                      bias=None):
    """The plain version of `int8_conv2d`, on any device: an exact integer
    convolution (a float64 `F.conv2d` of the s8 values, whose products and
    sums are integers below 2^53, so exact in any order; cuDNN off, so a
    CUDA tensor takes PyTorch's own im2col and matrix product, never a
    transform), in bands of output rows whose im2col stays near 2 GiB,
    then the epilogue as a separate f32 multiply and add, rounded once to
    bf16."""
    w_q, mult, bias = _weight_args(w, mult, bias)
    if s_in is not None:
        x = quant_act(x, s_in)
    if x.dtype != torch.int8:
        raise TypeError(f"x is {x.dtype}: s8, or a float with s_in")
    cout, cin, kh, kw = w_q.shape
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    (pt, pb), (pl, pr) = _padding(kh, kw, padding)
    xd = F.pad(x.to(torch.float64), (0, 0, pl, pr, pt, pb))
    ho = (xd.shape[1] - kh) // sh + 1
    wo = (xd.shape[2] - kw) // sw + 1
    wd = w_q.to(torch.float64)
    rows = max(1, PLAIN_BAND // (x.shape[0] * wo * cin * kh * kw))
    bands = []
    with torch.backends.cudnn.flags(enabled=False):
        for r0 in range(0, ho, rows):
            r1 = min(ho, r0 + rows)
            band = xd[:, r0 * sh:(r1 - 1) * sh + kh].permute(0, 3, 1, 2)
            bands.append(F.conv2d(band, wd, stride=(sh, sw))
                         .permute(0, 2, 3, 1).to(torch.int32))
    acc = torch.cat(bands, 1).contiguous()
    if mult is None:
        return acc
    return (acc.float() * mult + bias).to(torch.bfloat16)


def _weight_args(w, mult, bias):
    if isinstance(w, Int8Weight):
        if mult is not None or bias is not None:
            raise ValueError("an Int8Weight carries its own mult and bias")
        return w.w_q, w.mult, w.bias
    return w, mult, bias


def _check(name, t, device, dtypes):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")


def int8_conv2d(x, w, stride=1, padding=None, s_in=None, mult=None,
                bias=None):
    """s8 x s8 -> s32 NHWC convolution (the JAX package's `int8_conv2d`),
    optionally quantizing its input and dequantizing its output.

    x: (N, H, W, Cin) s8, or bf16 / f32 with `s_in` (quantized with
    `quant_act`'s arithmetic).  w: an s8 OIHW tensor or an `Int8Weight`
    (whose kernel layout is then built once).  padding as the JAX
    package's (None: (k-1)//2 each side).  Returns s32 (N, Ho, Wo, Cout),
    or bf16(f32(acc) * mult + bias) with `mult` and `bias` ((Cout,) f32).
    On H-strips (`ops/strips.py`) each rank convolves the rows its output
    rows read, fetched from its neighbours."""
    if spatial_ctx.active():
        kh, kw = (w.w_q if isinstance(w, Int8Weight) else w).shape[2:]
        (pt, pb), (pl, pr) = _padding(kh, kw, padding)
        sh = stride if isinstance(stride, int) else stride[0]
        with_rows = functools.partial(
            _int8_conv2d, w=w, stride=stride, padding=((0, 0), (pl, pr)),
            s_in=s_in, mult=mult, bias=bias)
        return strips.conv_rows(x, kh, sh, (pt, pb), with_rows)
    return _int8_conv2d(x, w, stride, padding, s_in, mult, bias)


def _int8_conv2d(x, w, stride, padding, s_in, mult, bias):
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, w, stride, padding, s_in, mult, bias)
    args, out = _kernel_args(x, w, stride, padding, s_in, mult, bias)
    err = _lib().lssvc_int8_conv(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    int8_conv2d.launches += 1
    return out


int8_conv2d.launches = 0

# the fields of the kernel's plan (`lssvc_int8_plan` of csrc/int8_conv.cu)
PLAN_FIELDS = ("ring", "staging", "stages", "taps_a_stage", "pitch", "th",
               "tw", "mtiles", "tiles", "grid", "smem", "vec_in",
               "vec_store")


def int8_conv_plan(x, w, stride=1, padding=None, s_in=None, mult=None,
                   bias=None) -> dict:
    """The plan the kernel would launch `int8_conv2d` with on these CUDA
    tensors, launching nothing: weights in a ring of `stages` (else
    resident), the raw halo staged (else loaded directly), the tile and the
    grid (`PLAN_FIELDS`)."""
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}: the kernel plans CUDA tensors")
    args, _ = _kernel_args(x, w, stride, padding, s_in, mult, bias)
    info = (ctypes.c_int * len(PLAN_FIELDS))()
    err = _lib().lssvc_int8_plan(*args, info)
    if err != 0:
        raise RuntimeError(f"int8_conv has no plan: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, info))


def _kernel_args(x, w, stride, padding, s_in, mult, bias):
    """The C entry point's arguments but the last, and the output they
    write."""
    w_q, mult, bias = _weight_args(w, mult, bias)
    kern = w if isinstance(w, Int8Weight) else Int8Weight(w_q, mult, bias)
    dev = x.device
    n, h, wd, cin = x.shape
    cout, wcin, kh, kw = w_q.shape
    if wcin != cin:
        raise ValueError(f"x has {cin} channels, the kernel {wcin}")
    _check("x", x, dev, (torch.int8,) if s_in is None
           else (torch.bfloat16, torch.float32))
    _check("w", w_q, dev, (torch.int8,))
    if not isinstance(stride, int):
        if stride[0] != stride[1]:
            raise ValueError(f"stride {stride}: the kernel takes one stride")
        stride = stride[0]
    (pt, pb), (pl, pr) = _padding(kh, kw, padding)
    if min(pt, pb, pl, pr) < 0 or stride < 1:
        raise ValueError(f"padding {((pt, pb), (pl, pr))}, stride {stride}")
    ho, wo = (h + pt + pb - kh) // stride + 1, (wd + pl + pr - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"no output rows or columns ({ho}x{wo})")
    x = x.contiguous()
    lay = kern.layout()
    if mult is None:
        out = torch.empty((n, ho, wo, cout), dtype=torch.int32, device=dev)
        mp = bp = None
    else:
        mult, bias = mult.float().contiguous(), bias.float().contiguous()
        for name, t in (("mult", mult), ("bias", bias)):
            _check(name, t, dev, (torch.float32,))
            if tuple(t.shape) != (cout,):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected ({cout},)")
        out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16,
                          device=dev)
        mp, bp = mult.data_ptr(), bias.data_ptr()
    s = 0.0 if s_in is None else float(np.float32(s_in))
    return (x.data_ptr(), lay.data_ptr(), out.data_ptr(), mp, bp, s, n, h,
            wd, cin, ho, wo, cout, kern.cout_pad, kern.cinp, kh, kw, stride,
            pt, pl, _IN_DTYPES[x.dtype], int(mult is not None)), out


def dequant(acc, act_scale, w_scale, b=None):
    """s32 accumulator -> f32, fused scale + optional bias."""
    dev = acc.device
    y = acc.float() * (f32_scalar(act_scale, dev) * w_scale.float())
    if b is not None:
        y = y + b.float()
    return y


def requant(acc, act_scale, w_scale, out_scale, b=None, relu=False):
    """s32 accumulator -> next layer's s8 with one fused multiplier."""
    dev = acc.device
    out_s = f32_scalar(out_scale, dev)
    mult = (f32_scalar(act_scale, dev) / out_s) * w_scale.float()
    y = acc.float() * mult
    if b is not None:
        y = y + b.float() / out_s
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.round(y).clamp_(-127, 127).to(torch.int8)


def fixed_point_multiplier(act_scale, w_scale, out_scale, w_q=None,
                           mult_bits=15):
    """Host-side: fold (act_scale * w_scale / out_scale) into an integer
    multiply+shift triple for an all-integer requant (the JAX package's
    `fixed_point_multiplier`, numpy only): y = clamp(((acc >>r acc_shift)
    * M) >>r post), acc_shift per output channel from the accumulator
    bound 127 * sum|w_q| (w_q OIHW here; None: 3x3x192 full-scale taps).

    Returns (M, post, acc_shift) as s32 numpy arrays of shape (O,)."""
    m = (np.float64(act_scale) * np.asarray(w_scale, np.float64)
         / np.float64(out_scale))
    m = np.atleast_1d(m)
    if w_q is not None:
        wq = np.asarray(w_q.cpu() if isinstance(w_q, torch.Tensor) else w_q,
                        np.float64)
        bound = np.broadcast_to(
            np.atleast_1d(127.0 * np.abs(wq).sum(axis=(1, 2, 3))), m.shape)
    else:
        bound = np.full(m.shape, 127.0 * 127 * 3 * 3 * 192)
    acc_bits = np.ceil(np.log2(np.maximum(bound, 1.0))).astype(np.int32)
    acc_shift = np.maximum(acc_bits + mult_bits - 31, 0).astype(np.int32)
    post = np.zeros(m.shape, np.int32)
    mm = np.zeros(m.shape, np.int64)
    for i, mi in enumerate(m):
        if mi <= 0:
            continue
        e = int(np.floor(np.log2(mi)))
        p = mult_bits - 1 - e - int(acc_shift[i])
        mi_int = int(round(mi * 2.0 ** (p + int(acc_shift[i]))))
        if mi_int >= 2 ** mult_bits:  # rounding carried into the next octave
            mi_int >>= 1
            p -= 1
        mm[i], post[i] = mi_int, p
    post = np.maximum(post, 0)
    # shifts of 31 or more are undefined in s32: fold the excess into M,
    # which underflows toward 0 (a dead channel's requant output is ~0)
    excess = np.maximum(post - 30, 0)
    if excess.any():
        mm = mm >> excess
        post = post - excess
    return mm.astype(np.int32), post.astype(np.int32), acc_shift


def requant_fixed(acc, M, post, acc_shift, relu=False):
    """All-integer s32 -> s8 requant: rounding shift, per-channel multiply,
    rounding shift, clamp (the JAX package's `requant_fixed`)."""
    def s32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=acc.device)

    M, post, acc_shift = s32(M), s32(post), s32(acc_shift)
    one = torch.ones((), dtype=torch.int32, device=acc.device)
    half = (one << acc_shift) >> 1
    y = ((acc + half) >> acc_shift) * M
    y = (y + ((one << post) >> 1)) >> post
    if relu:
        y = torch.clamp_min(y, 0)
    return y.clamp(-127, 127).to(torch.int8)


def int8_conv_ref(x, w, act_scale, b=None, stride=1):
    """Float-in/float-out quantized conv (quantize -> s8 conv -> dequant);
    w OIHW."""
    w_q, w_scale = quant_weight(w)
    acc = int8_conv2d(quant_act(x, act_scale), w_q, stride=stride)
    return dequant(acc, act_scale, w_scale, b=b)


# ---------------------------------------------------------------------------
# The serving state of a model


def calib_key(prefix: str, w) -> str:
    """A site's calibration key: its scope prefix plus the unpacked
    kernel's `Cin x Cout` (OIHW: w.shape[1] x w.shape[0]; a depthwise
    (C, 1, kh, kw) gives 1xC, as the JAX package's HWIO (kh, kw, 1, C))."""
    return f"{prefix}{w.shape[1]}x{w.shape[0]}"


def table_from_stats(stats: dict, margin: float = 1.0) -> dict:
    """absmax stats (0-d tensors or floats) -> calibration table."""
    return {k: float(max(np.float64(float(v)) * margin, 1e-8)) / 127.0
            for k, v in stats.items()}


@dataclasses.dataclass(eq=False)
class Int8Sites:
    """A model's int8 state: `table` (calibration key -> activation scale)
    serves the sites of the int8 precision, `served` collects the keys it
    served, and `stats`, while a `recording` is open, collects each site's
    input absmax (a 0-d f32 tensor, merged by max); `calls` counts the
    site calls served, each one `int8_conv2d` launch on the card.  A base
    layer shares its model's, so the BL's keys (without
    `base_layer_model.`) and the EL's meet in one table, as in the JAX
    package's flat global one (SpyNet's sites are such shared keys)."""

    table: dict = dataclasses.field(default_factory=dict)
    served: set = dataclasses.field(default_factory=set)
    stats: dict | None = None
    calls: int = 0

    def record(self, key: str, x: torch.Tensor):
        """A conv site's input; kept only inside a recording."""
        if self.stats is not None:
            a = strips.level_max(x.float().abs())
            prev = self.stats.get(key)
            self.stats[key] = a if prev is None else torch.maximum(prev, a)

    def scale_for(self, key: str):
        """The activation scale of a calibrated site (and the site is
        served), or None for the float path."""
        s = self.table.get(key)
        if s is not None:
            self.served.add(key)
            self.calls += 1
        return s
