"""Fused conv chains: a CUDA kernel on the GPU, the plain version on the CPU.

The counterpart of the JAX package's `lssvc_tpu/ops/conv_chain.py`: a chain
of convolutions over NHWC input, described by a list of layer specs in the
same format, with weights in torch layouts:

  {"kind": "conv3", "w": (Co, Ci, 3, 3), "b": (Co,)|None, "slope": float|None}
  {"kind": "conv1", "w": (Co, Ci, 1, 1), ...}        1x1 conv
  {"kind": "dw3",   "w": (C, 1, 3, 3),   ...}        depthwise 3x3 conv
  {"kind": "act",   "slope": float}                  standalone leaky ReLU
  {"kind": "save", "tag": t}                         mark a residual source
  {"kind": "add_saved", "tag": t}                    add the saved tensor
  a conv spec with "branch": t                       side conv: its result is
                                                     saved under t and the
                                                     main path goes on from
                                                     the tensor it read

Every conv sees zero padding at the true image border.  Operands are in the
compute dtype `cdtype` (bf16 for a bf16 input, else f32, unless given);
products accumulate in f32, the bias is f32, and each layer's result
(conv, act, add_saved) is rounded once to `cdtype`.  The output is in
`cdtype`.

A CUDA tensor launches the hand-written kernel of `csrc/conv_chain.cu`
(built at first use, see build.py) or raises; a CPU tensor takes
`conv_chain_plain`.  The kernel runs the whole chain for one image in one
launch, tile by tile with the chain's halo, so no intermediate tensor is
written to device memory; `conv_chain.launches` counts its launches (one per
image).  The JAX function's `tr` argument (the TPU strip height) has no
counterpart: the kernel picks its own tile.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"conv3": 0, "conv1": 1, "dw3": 2, "act": 3, "add_saved": 4}
_SPATIAL = ("conv3", "dw3")
MAX_OPS = 64            # csrc/conv_chain.cu kMaxOps
ROW_PAD = 8             # csrc/conv_chain.cu kQ: weight rows pad to it
SMEM_BYTES = 232448     # dynamic shared memory a Hopper block can use
# output tiles (rows, cols), largest first: the first whose slots fit in
# shared memory is taken; else the last, with its slots in global memory
TILES = ((16, 16), (8, 16), (8, 8))
SCRATCH_BLOCKS = 132 * 4  # blocks in flight when the slots are in global memory
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("conv_chain")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.lssvc_conv_chain.argtypes = (
            [vp] * 7 + [i32] * 12 + [i64, i32, i32, i32, vp])
        lib.lssvc_conv_chain.restype = i32
        _LIB = lib
    return _LIB


def _cdtype(x, cdtype):
    if cdtype is None:
        return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return cdtype


def _leaky(a, slope):
    return torch.where(a >= 0, a, a * slope)


def conv_chain_plain(x, specs, cdtype=None):
    """The plain version: F.conv2d in f32 on operands already rounded to
    `cdtype`, then the f32 bias and leaky ReLU, then a rounding to `cdtype`:
    the kernel's rounding points."""
    cdtype = _cdtype(x, cdtype)
    cur = x.to(cdtype).permute(0, 3, 1, 2)
    saved = {}
    for s in specs:
        kind = s["kind"]
        if kind == "save":
            saved[s.get("tag")] = cur
        elif kind == "add_saved":
            sv = saved[s.get("tag")]
            if sv.shape != cur.shape:
                raise ValueError(f"add_saved of {tuple(sv.shape)} to "
                                 f"{tuple(cur.shape)}")
            cur = (cur.float() + sv.float()).to(cdtype)
        elif kind == "act":
            cur = _leaky(cur.float(), s["slope"]).to(cdtype)
        else:
            w = s["w"].to(cur.device, cdtype).float()
            y = F.conv2d(cur.float(), w, padding=0 if kind == "conv1" else 1,
                         groups=cur.shape[1] if kind == "dw3" else 1)
            if s.get("b") is not None:
                y = y + s["b"].to(y.device, torch.float32)[None, :, None, None]
            if s.get("slope") is not None:
                y = _leaky(y, s["slope"])
            y = y.to(cdtype)
            if s.get("branch"):
                saved[s["branch"]] = y
            else:
                cur = y
    return cur.permute(0, 2, 3, 1).contiguous()


def _pack_weight(kind, w):
    """torch layout -> the kernel's f32 rows: conv3 (9*Ci, Co), conv1
    (Ci, Co), dw3 (9, C), each row zero-padded to a multiple of ROW_PAD."""
    co, ci = w.shape[:2]
    if kind == "conv1":
        if tuple(w.shape[2:]) != (1, 1):
            raise ValueError(f"conv1 weight of shape {tuple(w.shape)}")
        rows = w[:, :, 0, 0].t()
    elif tuple(w.shape[2:]) != (3, 3) or (kind == "dw3" and ci != 1):
        raise ValueError(f"{kind} weight of shape {tuple(w.shape)}")
    else:  # (dy, dx, ci, co) rows
        rows = w.permute(2, 3, 1, 0).reshape(-1, co)
    return F.pad(rows, (0, -co % ROW_PAD))


class ConvChain:
    """A spec chain parsed and its weights packed once, for one compute
    dtype and device; calling it runs the chain on (N, H, W, C0) input.

    The parsing follows `lssvc_tpu/ops/conv_chain.py:222-265`: one logical
    buffer per layer, `depth` counting the spatial convs (branches too), the
    halo L = max(depth, 1).  Each buffer's region has a halo margin: L for
    the input, one less after every spatial layer.  Buffers are then
    assigned to a few physical slots by liveness."""

    def __init__(self, specs, c_in, cdtype=torch.float32, device="cuda"):
        if cdtype not in _DTYPES:
            raise TypeError(f"compute dtype {cdtype}, expected one of "
                            f"{list(_DTYPES)}")
        self.cdtype, self.c_in = cdtype, c_in
        ops = []            # [kind, src, dst, saved, depth, wi, slope]
        buf_cs = [c_in]
        weights, biases = [], []
        cur, saved, depth = 0, {}, 0
        for s in specs:
            kind = s["kind"]
            if kind == "save":
                saved[s.get("tag")] = cur
                continue
            if kind == "add_saved":
                sv = saved[s.get("tag")]
                if buf_cs[sv] != buf_cs[cur]:
                    raise ValueError(f"add_saved of {buf_cs[sv]} channels to "
                                     f"{buf_cs[cur]}")
                buf_cs.append(buf_cs[cur])
                ops.append([kind, cur, len(buf_cs) - 1, sv, depth, -1, None])
                cur = len(buf_cs) - 1
                continue
            if kind == "act":
                buf_cs.append(buf_cs[cur])
                ops.append([kind, cur, len(buf_cs) - 1, -1, depth, -1,
                            s["slope"]])
                cur = len(buf_cs) - 1
                continue
            if kind not in _KINDS:
                raise ValueError(f"unknown layer kind {kind!r}")
            w = s["w"].detach().cpu().to(cdtype).float()
            if w.shape[0 if kind == "dw3" else 1] != buf_cs[cur]:
                raise ValueError(f"{kind} weight {tuple(w.shape)} on "
                                 f"{buf_cs[cur]} channels")
            pw = _pack_weight(kind, w)
            co = w.shape[0]
            b = s.get("b")
            weights.append(pw.reshape(-1))
            biases.append(torch.zeros(co) if b is None
                          else b.detach().float().reshape(co).cpu())
            buf_cs.append(co)
            ops.append([kind, cur, len(buf_cs) - 1, -1, depth,
                        len(weights) - 1, s.get("slope")])
            if s.get("branch"):
                saved[s["branch"]] = len(buf_cs) - 1
            else:
                cur = len(buf_cs) - 1
            if kind in _SPATIAL:
                depth += 1
        if not ops:
            raise ValueError("a chain needs at least one layer")
        if len(ops) > MAX_OPS:
            raise ValueError(f"{len(ops)} layers, at most {MAX_OPS}")
        self.L = L = max(depth, 1)
        self.buf_cs, self.out_buf = buf_cs, cur
        self.c_out = buf_cs[cur]

        # halo margin of each buffer's region
        margin = [L] + [0] * (len(buf_cs) - 1)
        for kind, src, dst, _, d, _, _ in ops:
            margin[dst] = L - d - (1 if kind in _SPATIAL else 0)
        self.margin = margin

        # slots by liveness: a buffer lives from its op until its last read
        last = {0: -1}
        for i, (_, src, dst, sav, _, _, _) in enumerate(ops):
            last[src] = i
            if sav >= 0:
                last[sav] = i
            last.setdefault(dst, i)
        last[cur] = len(ops)
        slot_of, free, n_slots = {0: 0}, [], 1
        for i, (_, src, dst, sav, _, _, _) in enumerate(ops):
            if free:
                slot_of[dst] = free.pop(0)
            else:
                slot_of[dst], n_slots = n_slots, n_slots + 1
            for b in {src, sav, dst} - {-1}:
                if last.get(b, i) <= i:
                    free.append(slot_of[b])
        self.slot_of, self.n_slots = slot_of, n_slots

        elt = torch.empty((), dtype=cdtype).element_size()
        for th, tw in TILES:
            elems = self._slot_elems(th, tw)
            if n_slots * elems * elt <= SMEM_BYTES:
                self.smem_bytes = n_slots * elems * elt
                break
        else:
            self.smem_bytes = 0
        self.tile, self.slot_elems = (th, tw), elems

        woff = boff = 0
        recs, slopes = [], []
        for kind, src, dst, sav, _, wi, slope in ops:
            if wi >= 0:
                woff_i, boff_i = woff, boff
                woff += weights[wi].numel()
                boff += biases[wi].numel()
            else:
                woff_i = boff_i = 0
            recs += [_KINDS[kind], slot_of[src], slot_of[dst],
                     slot_of[sav] if sav >= 0 else 0, buf_cs[src], buf_cs[dst],
                     margin[src], margin[dst], margin[sav] if sav >= 0 else 0,
                     int(slope is not None), woff_i, boff_i]
            slopes.append(0.0 if slope is None else float(slope))
        self.ops = ops
        self._recs = (ctypes.c_int * len(recs))(*recs)
        self._slopes = (ctypes.c_float * len(slopes))(*slopes)
        self.specs = specs
        empty = torch.zeros(1)
        self.weights = torch.cat(weights or [empty]).to(device)
        self.biases = torch.cat(biases or [empty]).to(device)
        self.device = self.weights.device  # "cuda" resolved to "cuda:0"

    def _slot_elems(self, th, tw):
        """Elements of one slot: the largest buffer region, stored channel
        by channel with an odd plane stride, 16-byte aligned."""
        n = max(((th + 2 * m) * (tw + 2 * m) | 1) * c
                for m, c in zip(self.margin, self.buf_cs))
        return -(-n // 8) * 8

    @property
    def in_shared_memory(self):
        return self.smem_bytes > 0

    def __call__(self, x):
        if x.ndim != 4 or x.shape[-1] != self.c_in:
            raise ValueError(f"input of shape {tuple(x.shape)}, expected "
                             f"(N, H, W, {self.c_in})")
        if x.device.type == "cpu":
            return conv_chain_plain(x, self.specs, self.cdtype)
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, chain on {self.device}")
        n, h, w, _ = x.shape
        x = x.to(self.cdtype).contiguous()
        out = torch.empty((n, h, w, self.c_out), dtype=self.cdtype,
                          device=x.device)
        th, tw = self.tile
        tiles = -(-h // th) * -(-w // tw)
        if self.in_shared_memory:
            grid, scratch = tiles, None
        else:
            grid = min(tiles, SCRATCH_BLOCKS)
            scratch = torch.empty(grid * self.n_slots * self.slot_elems,
                                  dtype=self.cdtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i in range(n):
            err = _lib().lssvc_conv_chain(
                x[i].data_ptr(), out[i].data_ptr(), self.weights.data_ptr(),
                self.biases.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                self._recs, self._slopes, len(self.ops), h, w, self.c_in,
                self.c_out, self.L, th, tw, self.slot_of[0],
                self.slot_of[self.out_buf], self.margin[self.out_buf],
                self.n_slots, self.slot_elems, grid, self.smem_bytes,
                _DTYPES[self.cdtype], stream)
            if err != 0:
                raise RuntimeError(f"conv_chain kernel launch failed: CUDA "
                                   f"error {err}")
            conv_chain.launches += 1
        return out


def conv_chain_specs(x, specs, cdtype=None):
    """Run a layer-spec chain over (N, H, W, C) NHWC input.  A caller that
    runs one chain many times builds a `ConvChain` once instead, which packs
    the weights once."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, specs, cdtype)
    return ConvChain(specs, x.shape[-1], _cdtype(x, cdtype), x.device)(x)


def conv_chain(x, weights, biases=None, slopes=None, cdtype=None):
    """A uniform 3x3 chain: weights[l] is (Co, Ci, 3, 3).  `launches`
    counts every launch of the chain kernel, from any entry point here."""
    n = len(weights)
    biases = [None] * n if biases is None else biases
    slopes = [None] * n if slopes is None else slopes
    specs = [{"kind": "conv3", "w": w, "b": b, "slope": s}
             for w, b, s in zip(weights, biases, slopes)]
    return conv_chain_specs(x, specs, cdtype=cdtype)


conv_chain.launches = 0
