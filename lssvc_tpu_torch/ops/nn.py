"""Core NN primitives on NHWC activations with torch-layout parameters.

Semantics match the JAX package's `lssvc_tpu/ops/nn.py` (and through it the
reference's Conv2d / ConvTranspose2d / PixelShuffle / pooling / GDN).  A
conv runs `F.conv2d` on `x.permute(0, 3, 1, 2)`: for a contiguous NHWC
tensor that is a channels_last view, which cuDNN takes as it is, and the
result permuted back is contiguous NHWC again.

The numerics are a `Mode` (the JAX package's process-wide precision,
packed-width and 1x1-einsum switches): a model enters its mode with
`precision_scope` around each public call, and the functions here read it
through `current_mode()`.  Nothing outlives the scope.

Row-local products (GDN's `x^2 @ gamma^T`, the 1x1 convs run as matmuls,
OffsetDiversity's fusion) go through `rows_matmul`: GEMMs of one fixed
row count, so that a row's result does not depend on how many rows the
tensor holds.  cuBLAS (and the CPU's BLAS) pick their kernel, and with it
the order of a row's sums, by the matrix's shape; an H-strip of a frame
then gave other last bits than the frame's own rows.  cuDNN picks a
conv's algorithm by the call's shape too; on H-strips each conv shape
takes a route whose rows are the frame's bits (`ops/strips.py` `conv2d`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import spatial_ctx, strips
from .int8 import Int8Sites

PRECISIONS = ("fp32", "high", "bf16", "bf16_f32out", "int8")
# the precisions whose conv and matmul operands are bf16
BF16_OPERANDS = ("bf16", "bf16_f32out", "int8")


def set_fp32_parity():
    """The fp32 parity mode's backend flags, set process-wide (the tools
    that time plain convolutions outside a model): full-fp32,
    deterministic convolutions and matmuls.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits); the JAX package runs them at `Precision.HIGHEST`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


@dataclasses.dataclass(frozen=True)
class Mode:
    """A model's numerics (the JAX package's process-wide switches of
    `ops/nn.py:24-31,53-106,166-195`, held per model here).

    precision:
      "fp32"  f32 operands and outputs, TF32 off (the parity mode);
      "high"  f32 activations, TF32 convolutions and matmuls on the card
              (PyTorch's meaning of the word; the JAX package's 3-pass
              bf16 `Precision.HIGH`), plain f32 on the CPU;
      "bf16"  bf16 conv and matmul operands AND outputs, f32 accumulation,
              f32 parameters; elementwise work in whatever dtype the conv
              gave;
      "bf16_f32out"  bf16 operands, f32 outputs (the bench ablation): the
              operands are rounded to bf16 and kept as f32 tensors, and
              the conv runs with TF32 on; a bf16 value is exact in TF32 and
              its products are exact in f32, so this is "bf16 operands, f32
              accumulation" on the tensor cores;
      "int8"  bf16 as above, except at the calibrated packed sites, which
              run the s8 convolution (`ops/int8.py`, `models/packed_blocks.py`)
              with the scales of `int8.table`; an uncalibrated site is the
              bf16 path bit for bit.
    packed_width: 2 routes the full-res stride-1 stacks through the
      width-packed domain (`ops/packed.py`).
    conv1x1_einsum: 1x1 stride-1 ungrouped convs as matmuls.
    packed_ctx: under packed width 2, the EL pair warp stores straight into
      the packed domain and OffsetDiversity reads it there (the JAX
      package's `LSSVC_PACKED_CTX`, `models/lssvc.py:34,159-178`).
    cache: the model's packed kernels (`models/packed_blocks.py`).
    int8: the model's calibration table, served sites and absmax recorder
      (`ops.int8.Int8Sites`); the recorder works in every precision, the
      table serves only in "int8"."""

    precision: str = "fp32"
    packed_width: int = 1
    conv1x1_einsum: bool = False
    packed_ctx: bool = False
    cache: dict | None = dataclasses.field(default=None, compare=False)
    int8: Int8Sites = dataclasses.field(default_factory=Int8Sites,
                                        compare=False)

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r}, expected one "
                             f"of {PRECISIONS}")
        if self.packed_width not in (1, 2):
            raise ValueError(f"packed_width {self.packed_width}, expected "
                             "1 or 2")


_FP32 = Mode()
_STATE = threading.local()
# The backend flags a mode sets (TF32, cuDNN's algorithm choice) are
# process-wide; the mode is per thread.  Scopes on several threads (the
# CLI's worker pool) share the flags: they are set by the first holder and
# restored only when the last one leaves; a scope that needs other flags
# than another thread holds raises.  One thread may nest a scope with
# other flags while it holds the flags alone.
_FLAGS_LOCK = threading.Lock()
_HOLDERS: list = []  # (thread ident, flags), one per open scope
_SAVED_FLAGS: list = []  # the flags before the first holder


def current_mode() -> Mode:
    """The mode of the innermost `precision_scope` (fp32 outside any)."""
    return getattr(_STATE, "mode", _FP32)


def backend_flags(precision: str) -> tuple:
    """The backend flags (cudnn TF32, matmul TF32, benchmark,
    deterministic) a scope of `precision` sets: TF32 only for "high" and
    "bf16_f32out"; in every precision cuDNN's heuristic, never its timed
    choice, and only algorithms that sum in a fixed order."""
    tf32 = precision in ("high", "bf16_f32out")
    return (tf32, tf32, False, True)


def _backend_flags() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
            cudnn.deterministic)


def _set_backend_flags(flags: tuple):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
     cudnn.deterministic) = flags


@contextlib.contextmanager
def precision_scope(mode: Mode):
    """Run the block in `mode`: the functions of the port read it through
    `current_mode()`, and the backend flags are set for it
    (`backend_flags`: the fixed-order algorithms make a stream's encoder
    and decoder, in another process, compute each conv bit for bit alike;
    `conv_transpose2d` takes forward convs for the same reason).  The flags are process-wide: scopes open on other threads
    must need the same ones (else RuntimeError), and they are restored
    when the last scope of the process closes, so nothing leaks into the
    caller or into another model."""
    want = backend_flags(mode.precision)
    me = threading.get_ident()
    with _FLAGS_LOCK:
        others = {flags for t, flags in _HOLDERS if t != me}
        if others - {want}:
            raise RuntimeError(
                f"precision_scope({mode.precision!r}) needs backend flags "
                f"(cudnn TF32, matmul TF32, benchmark, deterministic) = "
                f"{want}, but another thread's scope holds {others}")
        if not _HOLDERS:
            _SAVED_FLAGS[:] = [_backend_flags()]
        _HOLDERS.append((me, want))
        _set_backend_flags(want)
    before = current_mode()
    _STATE.mode = mode
    try:
        yield mode
    finally:
        _STATE.mode = before
        with _FLAGS_LOCK:
            _HOLDERS.remove((me, want))
            mine = [flags for t, flags in _HOLDERS if t == me]
            # the flags of this thread's enclosing scope, else those every
            # other holder shares, else the flags before the first scope
            _set_backend_flags(mine[-1] if mine else
                               _HOLDERS[-1][1] if _HOLDERS else
                               _SAVED_FLAGS[0])


def compute_dtype() -> torch.dtype:
    """The dtype of conv and matmul operands in the current mode."""
    return (torch.bfloat16 if current_mode().precision in BF16_OPERANDS
            else torch.float32)


def packed_width() -> int:
    return current_mode().packed_width


def _operands(x, w, b):
    """(x, w, b) as the current mode's conv takes them: bf16 for "bf16"
    and "int8" (the bias too: F.conv2d adds it inside the conv, so the
    output is rounded once, where the JAX package rounds the conv and then
    the sum, `ops/nn.py:254`); bf16-rounded f32 for "bf16_f32out"; as
    given otherwise."""
    prec = current_mode().precision
    if prec in ("bf16", "int8"):
        bf = torch.bfloat16
        return x.to(bf), w.to(bf), None if b is None else b.to(bf)
    if prec == "bf16_f32out":
        def rounded(t):
            return t.to(torch.bfloat16).float()

        return rounded(x), rounded(w), b
    return x, w, b


# rows of one GEMM of `rows_matmul`: on the card enough to fill it (a
# 32768 x 128 x 128 product is 256 tiles of 128 x 128), on the CPU few, so
# that the CPU tests' small frames pad little
ROWS_CUDA, ROWS_CPU = 32768, 1024


def rows_matmul(a, b, out_dtype=None):
    """a (..., K) @ b (K, N), a's rows flattened and taken `ROWS_CUDA`
    (`ROWS_CPU` on the CPU) at a time, the last chunk padded with zero
    rows: every GEMM runs at one shape, so a row's result is the same bits
    in a tensor of any row count (an H-strip and its whole frame).  Each
    chunk's product is written in place into the one output (under
    autograd, where `out=` does not differentiate, the chunks are
    concatenated).  `out_dtype` float32: bf16 operands with an f32 product
    (`torch.mm(..., out_dtype=)`, on the card)."""
    lead, k, n = a.shape[:-1], a.shape[-1], b.shape[-1]
    rows = a.reshape(-1, k)
    if type(rows) is not torch.Tensor:  # a strips.Whole level
        rows = rows.as_subclass(torch.Tensor)
    m = rows.shape[0]
    step = ROWS_CUDA if rows.is_cuda else ROWS_CPU
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}

    def padded(chunk):  # the last, short chunk at the GEMMs' one shape
        r = chunk.shape[0]
        return torch.mm(F.pad(chunk, (0, 0, 0, step - r)), b, **kw)[:r]

    if torch.is_grad_enabled() and (rows.requires_grad or b.requires_grad):
        parts = [padded(rows[i:i + step]) for i in range(0, m, step)]
        out = torch.cat(parts) if parts else torch.mm(rows, b, **kw)
        return out.reshape(*lead, n)
    out = torch.empty((m, n), dtype=out_dtype or torch.promote_types(
        rows.dtype, b.dtype), device=rows.device)
    for i in range(0, m, step):
        if m - i >= step:
            torch.mm(rows[i:i + step], b, **kw, out=out[i:i + step])
        else:
            out[i:] = padded(rows[i:])
    return out.reshape(*lead, n)


def matmul_f32out(a, b):
    """a @ b with operands in the compute dtype and an f32 product (the
    JAX package's `einsum(..., preferred_element_type=float32)`), by
    `rows_matmul`.  With bf16 operands on the card: cuBLAS's bf16 GEMM with
    an f32 output (f32 accumulation on the tensor cores); on the CPU the
    bf16-rounded operands multiply in f32.  Neither reads the process-wide
    TF32 flags, which another thread's scope may hold."""
    if compute_dtype() == torch.float32:
        return rows_matmul(a, b)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return rows_matmul(a.float(), b.float())
    return rows_matmul(a, b, torch.float32)


def matmul_highest(a, b):
    """a @ b in full f32 whatever the TF32 flags (the JAX package's
    `Precision.HIGHEST` products).  The flags are process-wide and another
    thread's "high" scope may hold TF32 on, so on the card the product is
    taken in float64 and rounded to f32 once; on the CPU, where the flags
    do nothing, in f32."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(a.dtype)


def precision_from_cli(precision: str, int8_calib=None):
    """The CLIs' `--precision` and `--int8_calib` (the JAX package's
    `apply_precision_cli`, `ops/nn.py:83-102`): (precision, int8 table).
    int8 needs a calibration table (`python -m
    lssvc_tpu_torch.tools.int8_calibrate`), read here from its JSON; the
    encoder and the decoder must use the same one.  Other precisions read
    no table."""
    if precision not in ("fp32", "high", "bf16", "int8"):
        raise ValueError(f"--precision {precision!r}: expected fp32, high, "
                         "bf16 or int8")
    if precision != "int8":
        return precision, None
    if not int8_calib:
        raise SystemExit(
            "--precision int8 requires --int8_calib <table.json> "
            "(produce one with tools/int8_calibrate.py)")
    with open(int8_calib) as f:
        return precision, {k: float(v) for k, v in json.load(f).items()}


def serving_mode(precision: str, int8_table=None) -> dict:
    """A model's mode keywords for a CLI precision: int8 adds packed width
    2 and its table (the JAX package's CLI preset, `ops/nn.py:100-102`)."""
    if precision == "int8":
        if int8_table is None:
            raise ValueError("precision int8 needs a calibration table")
        return dict(precision="int8", packed_width=2, int8_table=int8_table)
    return dict(precision=precision)


def packed_ctx_from_env() -> bool:
    """`LSSVC_PACKED_CTX=1`: the fused packed pair warp under packed width
    2, read as the JAX package's `models/lssvc.py:34` reads it."""
    return os.environ.get("LSSVC_PACKED_CTX", "0") == "1"


# Serving cap on OffsetDiversity's diversity offsets, in pixels (the JAX
# package's CLI preset, `ops/nn.py:104-128`).  Encoder and decoder compute
# offsets from decoded data, so the same cap keeps their streams in step.
# Here it is an explicit attribute of the model (`LSSVC.od_offset_cap`);
# None leaves the offsets uncapped, as training does.
OD_OFFSET_CAP_SERVING = 10.0


def od_offset_cap_from_env():
    """The CLIs' cap: `LSSVC_OD_OFFSET_CAP` px, read as the JAX package's
    CLI reads it (`ops/nn.py:106,123`): 10 by default, no cap for 0 or an
    empty value."""
    value = os.environ.get("LSSVC_OD_OFFSET_CAP", "10")
    return float(value) if value and float(value) else None


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    # channels_last output of a conv or pool: a free view back to NHWC
    return y.permute(0, 2, 3, 1).contiguous()


def _pad(x, pad_lrtb, value=0.0):
    left, right, top, bottom = pad_lrtb
    if left == right == top == bottom == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def pad_nhwc(x, pad_lrtb, value=0.0):
    """Pad/crop W (left, right) and H (top, bottom) of an NHWC tensor;
    negative entries crop, like torch.nn.functional.pad.  On H-strips
    (`ops/strips.py`) H is padded at the frame's top and bottom."""
    if spatial_ctx.active():
        return strips.pad(x, pad_lrtb, value, _pad)
    return _pad(x, pad_lrtb, value)


def conv2d(x, w, b=None, stride=1, padding=None, groups=1):
    """2D convolution in the current mode. x: NHWC, w: OIHW ((out,
    in/groups, kh, kw)).

    `padding` defaults to (k-1)//2 per axis; pass an int, (ph, pw) or
    ((top, bottom), (left, right)) (an uneven padding pads the input
    first).  On H-strips (`ops/strips.py` `conv2d`) each rank's rows are
    the frame's bits."""
    if padding is None:
        padding = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    elif isinstance(padding, int):
        padding = (padding, padding)
    if spatial_ctx.active():
        return strips.conv2d(x, w, b, stride, padding, groups, _conv2d,
                             (current_mode(), _backend_flags()))
    return _conv2d(x, w, b, stride, padding, groups)


def _conv2d(x, w, b, stride, padding, groups):
    x, w, b = _operands(x, w, b)
    ph, pw = padding
    if not (isinstance(ph, int) and isinstance(pw, int)):
        (top, bottom), (left, right) = ((p, p) if isinstance(p, int) else p
                                        for p in padding)
        x, padding = _pad(x, (left, right, top, bottom)), (0, 0)
    if (current_mode().conv1x1_einsum and w.shape[2:] == (1, 1)
            and groups == 1 and stride in (1, (1, 1))
            and tuple(padding) == (0, 0)):
        # the JAX package's `ops/nn.py:184-195,248-255`: a matmul, then
        # the bias in the output's dtype
        out = rows_matmul(x, w[:, :, 0, 0].t())
        return out if b is None else out + b.to(out.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding,
                          groups=groups))


# A stride-2 3x3 transposed conv (padding 1, output padding 1) as one 2x2
# conv to 4x the channels and a pixel shuffle: output row 2m takes input
# row m through kernel row 1; output row 2m+1 takes rows m and m+1 through
# kernel rows 2 and 0 (and the same along columns).  Keys (phase, input
# offset) -> kernel index; the other pairs are zero taps.
_DECONV_TAPS = {(0, 0): 1, (1, 0): 2, (1, 1): 0}


@functools.lru_cache(maxsize=None)
def _deconv_gather(device) -> torch.Tensor:
    """(a, b, di, dj) flattened -> the 3x3 tap feeding it (9: zero), on
    `device`."""
    gather = np.full((2, 2, 2, 2), 9, np.int64)
    for (a, di), ti in _DECONV_TAPS.items():
        for (b, dj), tj in _DECONV_TAPS.items():
            gather[a, b, di, dj] = 3 * ti + tj
    return torch.from_numpy(gather.reshape(-1)).to(device)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=1):
    """torch ConvTranspose2d on NHWC `x`; w is the un-flipped (I, O, 3, 3)
    weight.  Computed as forward convolutions (stride 1: the flipped,
    transposed kernel; stride 2: `_DECONV_TAPS`), whose cuDNN algorithms
    all sum in a fixed order: its transposed-conv algorithm 0 adds with
    atomics, so a stream's encoder and decoder could disagree in the last
    bit.  Only the models' two configurations are taken."""
    cin, cout, kh, kw = w.shape
    if (kh, kw, padding) == (3, 3, 1) and (stride, output_padding) == (1, 0):
        return conv2d(x, w.permute(1, 0, 2, 3).flip(2, 3), b)
    if (kh, kw, padding) != (3, 3, 1) or (stride, output_padding) != (2, 1):
        raise ValueError(f"conv_transpose2d of a {kh}x{kw} kernel, stride "
                         f"{stride}, padding {padding}, output padding "
                         f"{output_padding}: not a configuration of the models")
    taps = torch.cat([w.reshape(cin, cout, 9), w.new_zeros(cin, cout, 1)], -1)
    # (I, O, a, b, di, dj) -> (O, a, b, I, di, dj): out channel o*4 + 2a + b,
    # pixel_shuffle's order
    w2 = taps[:, :, _deconv_gather(w.device)].reshape(cin, cout, 2, 2, 2, 2) \
        .permute(1, 2, 3, 0, 4, 5).reshape(4 * cout, cin, 2, 2)
    b2 = None if b is None else b.repeat_interleave(4)
    # the 2x2 conv reads one row and column past each output: zero past the
    # frame's bottom and right
    return pixel_shuffle(conv2d(x, w2, b2, padding=((0, 1), (0, 1))), 2)


def _pixel_shuffle(x, r: int):
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, oc, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, oc)


def pixel_shuffle(x, r: int):
    """Sub-pixel upsample (torch PixelShuffle) on NHWC: C*r^2 -> C, HxW -> rHxrW."""
    if spatial_ctx.active():
        return strips.pixel_shuffle(x, r, _pixel_shuffle)
    return _pixel_shuffle(x, r)


def avg_pool2d(x, k: int = 2):
    def pool(t):
        return _nhwc(F.avg_pool2d(_nchw(t), k))

    return strips.pool2d(x, k, pool) if spatial_ctx.active() else pool(x)


def max_pool2d(x, k: int = 2):
    def pool(t):
        return _nhwc(F.max_pool2d(_nchw(t), k))

    return strips.pool2d(x, k, pool) if spatial_ctx.active() else pool(x)


def clip(x, lo: float, hi: float):
    """clip(x, lo, hi) as the JAX package's `jnp.clip` computes it,
    min(max(x, lo), hi): on a bound x takes half the gradient (a tie of
    `jnp.maximum` / `jnp.minimum`), where `torch.clamp` gives it all; the
    values are `torch.clamp`'s, NaN passing."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def ste_round(x):
    """round() with a straight-through gradient, written as the JAX package
    writes it (`x + stop_gradient(round(x) - x)`) so the forward values
    match; torch.round rounds half to even like jnp.round."""
    return x + (torch.round(x) - x).detach()


class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu whose gradient at 0 is 1, as the JAX package's
    `where(x >= 0, x, slope * x)` (torch's is the slope)."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.slope), None


class _ReLU(torch.autograd.Function):
    """F.relu whose gradient at 0 is 1/2, as the JAX package's
    `maximum(x, 0)` (torch's is 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.relu(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, grad, torch.where(x == 0, grad * 0.5,
                                                    grad.new_zeros(())))


def _differentiated(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def leaky_relu(x, negative_slope: float = 0.01):
    """Leaky ReLU; under autograd its gradient at 0 is JAX's (1)."""
    if _differentiated(x):
        return _LeakyReLU.apply(x, negative_slope)
    return F.leaky_relu(x, negative_slope)


def relu(x):
    """ReLU; under autograd its gradient at 0 is JAX's (1/2)."""
    if _differentiated(x):
        return _ReLU.apply(x)
    return F.relu(x)


# ---------------------------------------------------------------------------
# GDN (the JAX package's `ops/nn.py:356-379` reparameterisation)

_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_MIN = 1e-6
_BETA_BOUND = (_BETA_MIN + _PEDESTAL) ** 0.5
_GAMMA_BOUND = _REPARAM_OFFSET


def gdn(x, beta, gamma, inverse: bool = False):
    """Generalized divisive normalization over NHWC channels.

    beta: (C,), gamma: (C_out, C_in), both in the sqrt-reparameterized space
    the torch models store.  norm = x^2 @ gamma^T + beta; out = x * sqrt(norm)
    (inverse) or x * rsqrt(norm)."""
    # lower bounds as `jnp.maximum` (`lssvc_tpu/ops/nn.py:371-372`): at a
    # tie the parameter takes half the gradient; at init every off-diagonal
    # gamma sits on its bound
    beta = torch.square(torch.maximum(beta, beta.new_tensor(_BETA_BOUND))) \
        - _PEDESTAL
    gamma = torch.square(torch.maximum(gamma, gamma.new_tensor(_GAMMA_BOUND))) \
        - _PEDESTAL
    # the JAX package's einsum of bf16 x^2 with the f32 gamma computes in
    # f32 (type promotion), and so does x * rsqrt(f32 norm); torch's
    # matmul takes one dtype, so the square is cast explicitly; the product
    # is row-local, in GEMMs of one shape (`rows_matmul`)
    norm = rows_matmul(torch.square(x).to(gamma.dtype), gamma.t()) + beta
    if inverse:
        return x * torch.sqrt(norm)
    return x * torch.rsqrt(norm)
