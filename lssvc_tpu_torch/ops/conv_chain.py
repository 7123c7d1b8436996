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
image).  Its convolutions run on the tensor cores: bf16 products directly,
f32 products as three TF32 products of split operands (hi*hi + hi*lo +
lo*hi), so the kernel agrees with the plain version within a tolerance, not
bit for bit.  `ConvChain` packs the weights for that (`_pack_conv`) and
chooses the tile.  The JAX function's `tr` argument (the TPU strip height)
has no counterpart: the kernel picks its own tile.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"conv3": 0, "conv1": 1, "dw3": 2, "act": 3, "add_saved": 4}
_SPATIAL = ("conv3", "dw3")
_CONVS = ("conv3", "conv1")
MAX_OPS = 64            # csrc/conv_chain.cu kMaxOps
CH_PAD = 16             # channels pad to this: the bf16 wgmma's K step
CHUNK = 64              # output channels of one wgmma at most (kChunk)
GROUPS = 3              # warpgroups per block (kGroups)
SMEM_BYTES = 232448     # dynamic shared memory a Hopper block can use
PLANE_PAD = 72          # bf16: pixels past a region in each chunk plane
# output tiles (rows, cols) the plan chooses from
TILES = tuple((th, tw) for th in (4, 8, 12, 16, 24, 32)
              for tw in (8, 16, 24, 32, 48, 64))
STAGE_TAPS = (9, 3, 1)  # conv3 taps per weight stage, most first
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("conv_chain")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.lssvc_conv_chain.argtypes = (
            [vp] * 8 + [i32] * 13 + [i64, i32, i32, i32, vp])
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
    the kernel's rounding points.  The convolutions run in full f32 (cuDNN
    without TF32) whatever the caller set globally."""
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
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv2d(cur.float(), w,
                             padding=0 if kind == "conv1" else 1,
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


def _pad_to(n, m):
    return -(-n // m) * m


def tf32_round(a):
    """f32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: what `cvt.rna.tf32.f32` gives."""
    bits = a.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    return (bits - (bits >> 31 << 32)).to(torch.int32).view(torch.float32)


def _gemm_weight(kind, w, cin_p, cout_p):
    """A conv weight (Co, Ci, k, k) as the GEMM's B, (k*k*cin_p, cout_p):
    row (dy*k + dx)*cin_p + ci, zero in the pad rows and columns."""
    co, ci, k, _ = w.shape
    b = F.pad(w.permute(2, 3, 1, 0), (0, cout_p - co, 0, cin_p - ci))
    return b.reshape(k * k * cin_p, cout_p)


def _pack_b(b, elt):
    """B (K, N) in wgmma's K-major core-matrix layout without swizzle: 8
    columns x 16 bytes of K per core matrix, core matrices N-fastest, so
    that a stage of K rows is one contiguous range."""
    kel = 16 // elt
    k, n = b.shape
    return b.reshape(k // kel, kel, n // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def _pack_conv(kind, w, cin_p, cout_p, cdtype):
    """The kernel's weights of one conv: for each chunk of <= CHUNK output
    channels, its packed B; in f32, B's TF32 hi part then its lo part."""
    b = _gemm_weight(kind, w, cin_p, cout_p)
    if cdtype == torch.float32:
        hi = tf32_round(b)
        parts = (hi, tf32_round(b - hi))
    else:
        parts = (b,)
    elt = torch.empty((), dtype=cdtype).element_size()
    return torch.cat([_pack_b(p[:, n0:n0 + CHUNK].contiguous(), elt)
                      for n0 in range(0, cout_p, CHUNK) for p in parts])


class ConvChain:
    """A spec chain parsed and its weights packed once, for one compute
    dtype and device; calling it runs the chain on (N, H, W, C0) input.

    The parsing follows `lssvc_tpu/ops/conv_chain.py:222-265`: one logical
    buffer per layer, `depth` counting the spatial convs (branches too), the
    halo L = max(depth, 1).  Each buffer's region has a halo margin: L for
    the input, one less after every spatial layer.  Buffers are then
    assigned to a few physical slots by liveness; the last layer writes
    the output, which needs no slot.  Every buffer stores its channels
    padded to CH_PAD (zeros), at one pixel stride for the chain."""

    def __init__(self, specs, c_in, cdtype=torch.float32, device="cuda"):
        if cdtype not in _DTYPES:
            raise TypeError(f"compute dtype {cdtype}, expected one of "
                            f"{list(_DTYPES)}")
        self.cdtype, self.c_in = cdtype, c_in
        ops = []            # [kind, src, dst, saved, depth, wi, slope]
        buf_cs = [c_in]
        layers = []         # (weight, bias) of each conv and dw3
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
            if tuple(w.shape[2:]) != ((1, 1) if kind == "conv1" else (3, 3)) \
                    or (kind == "dw3" and w.shape[1] != 1):
                raise ValueError(f"{kind} weight of shape {tuple(w.shape)}")
            co = w.shape[0]
            b = s.get("b")
            layers.append((w, torch.zeros(co) if b is None
                           else b.detach().float().reshape(co).cpu()))
            buf_cs.append(co)
            ops.append([kind, cur, len(buf_cs) - 1, -1, depth,
                        len(layers) - 1, s.get("slope")])
            if s.get("branch"):
                saved[s["branch"]] = len(buf_cs) - 1
            else:
                cur = len(buf_cs) - 1
            if kind in _SPATIAL:
                depth += 1
        if cur == 0:
            raise ValueError("a chain needs a layer on its main path")
        # branch convs after the one that makes the output are never read
        while ops[-1][2] != cur:
            ops.pop()
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
        last = {}
        for i, (_, src, dst, sav, _, _, _) in enumerate(ops):
            last[src] = i
            if sav >= 0:
                last[sav] = i
            last.setdefault(dst, i)
        slot_of, free, n_slots = {0: 0, cur: -1}, [], 1
        for i, (_, src, dst, sav, _, _, _) in enumerate(ops[:-1]):
            if free:
                slot_of[dst] = free.pop(0)
            else:
                slot_of[dst], n_slots = n_slots, n_slots + 1
            for b in {src, sav, dst} - {-1}:
                if last.get(b, i) <= i:
                    free.append(slot_of[b])
        self.slot_of, self.n_slots = slot_of, n_slots
        self.ops = ops

        elt = torch.empty((), dtype=cdtype).element_size()
        self.elt = elt
        self.cp = [_pad_to(c, CH_PAD) for c in buf_cs]

        # weights: conv3/conv1 packed for wgmma in the compute dtype, dw3 in
        # f32 (9, C'); biases f32, padded per layer
        wmm, wdw, biases, self._woff, self._boff = [], [], [], {}, {}
        nm = nd = nb = 0
        for kind, src, dst, _, _, wi, _ in ops:
            if wi < 0:
                continue
            w, b = layers[wi]
            cin_p, cout_p = self.cp[src], self.cp[dst]
            if kind in _CONVS:
                packed = _pack_conv(kind, w, cin_p, cout_p, cdtype)
                self._woff[wi], nm = nm, nm + packed.numel()
                wmm.append(packed)
            else:
                rows = F.pad(w.permute(2, 3, 1, 0).reshape(9, -1),
                             (0, cout_p - w.shape[0]))
                self._woff[wi], nd = nd, nd + rows.numel()
                wdw.append(rows.reshape(-1))
            self._boff[wi], nb = nb, nb + cout_p
            biases.append(F.pad(b, (0, cout_p - b.numel())))

        self._choose_tile()
        recs, slopes = [], []
        for kind, src, dst, sav, _, wi, slope in ops:
            recs += [_KINDS[kind], slot_of[src], slot_of[dst],
                     slot_of[sav] if sav >= 0 else 0, self.cp[src],
                     self.cp[dst], margin[src], margin[dst],
                     margin[sav] if sav >= 0 else 0, int(slope is not None),
                     self._woff.get(wi, 0), self._boff.get(wi, 0),
                     self.taps]
            slopes.append(0.0 if slope is None else float(slope))
        self._recs = (ctypes.c_int * len(recs))(*recs)
        self._slopes = (ctypes.c_float * len(slopes))(*slopes)
        last_op = ops[-1]
        self.prefetch = int(self.in_shared_memory and c_in % CH_PAD == 0
                            and slot_of[0] not in (slot_of[last_op[1]],
                                                   slot_of.get(last_op[3])))
        self.specs = specs
        empty = torch.zeros(1)
        self.wmm = torch.cat(wmm or [empty]).to(device, cdtype)
        self.wdw = torch.cat(wdw or [empty]).to(device)
        self.biases = torch.cat(biases or [empty]).to(device)
        self.device = self.wmm.device  # "cuda" resolved to "cuda:0"

    def _convs(self):
        """(kind, K per tap, N, source and output buffer) of each conv3 and
        conv1."""
        for kind, src, dst, *_ in self.ops:
            if kind in _CONVS:
                yield kind, self.cp[src], self.cp[dst], src, dst

    def _npix(self, tile, m):
        th, tw = tile
        return (th + 2 * m) * (tw + 2 * m)

    def _slot_elems(self, tile):
        """Elements of one slot: the largest slotted buffer, chunk-planar,
        each chunk plane PLANE_PAD pixels longer than its region in bf16."""
        pad = PLANE_PAD if self.elt == 2 else 0
        return max((self._npix(tile, self.margin[b]) + pad) * self.cp[b]
                   for b, sl in self.slot_of.items() if sl >= 0)

    def _ring_bytes(self, taps):
        """Bytes of one weight stage buffer: the largest stage of any conv
        and output-channel chunk (conv1: its whole K)."""
        parts = 2 if self.cdtype == torch.float32 else 1
        return max([parts * (taps if kind == "conv3" else 1) * cin_p
                    * min(CHUNK, cout_p) * self.elt
                    for kind, cin_p, cout_p, _, _ in self._convs()] or [0])

    def _totals(self, cin_p):
        """Does a conv keep an f32 total beside its accumulators (f32, or
        bf16 from 64 input channels)?  conv_chunk's choice."""
        return self.cdtype == torch.float32 or cin_p >= 64

    def _passes(self, tile, cin_p, cout_p, src, dst, shared):
        """(N, M tiles per warpgroup) of each pass of one conv, as
        conv_passes runs them: M is the output region's pixels, at the
        source region's pitch where A comes by descriptor (bf16 slots in
        shared memory); at most 4 tiles at N <= 48 (2 with totals), half
        that at N = 64."""
        pitch = self.margin[src if shared and self.elt == 2 else dst]
        nmt = -(-(tile[0] + 2 * self.margin[dst]) * (tile[1] + 2 * pitch)
                // 64)
        for n0 in range(0, cout_p, CHUNK):
            nc = min(CHUNK, cout_p - n0)
            top = (2 if self._totals(cin_p) else 4) // (2 if nc == 64 else 1)
            m0 = 0
            while m0 < nmt:
                mt = min(top, -(-(nmt - m0) // GROUPS))
                yield nc, mt
                m0 += GROUPS * mt

    def tile_cost(self, tile, shared=True):
        """Tensor-core time per output pixel of a tile: K x N x the M tiles
        each warpgroup multiplies, halo and 64-row padding included."""
        return sum(cin_p * (9 if kind == "conv3" else 1) * nc * mt
                   for kind, cin_p, cout_p, src, dst in self._convs()
                   for nc, mt in self._passes(tile, cin_p, cout_p, src, dst,
                                              shared)) \
            / (tile[0] * tile[1])

    def _choose_tile(self):
        """The tile of least tensor-core time per output pixel whose slots
        and weight ring fit in shared memory, with the most taps per weight
        stage that fit; if none fits, slots in global memory, at most four
        blocks' worth of shared memory each."""
        best = None
        for tile in TILES:
            slot_bytes = self.n_slots * self._slot_elems(tile) * self.elt
            for taps in STAGE_TAPS:
                ring = self._ring_bytes(taps)
                if 2 * ring + slot_bytes <= SMEM_BYTES:
                    key = (self.tile_cost(tile), -taps, tile)
                    best = min(best or key, key)
                    break
        if best is not None:
            _, taps, self.tile = best
            self.taps, self.in_shared_memory = -taps, True
            self.slot_elems = self._slot_elems(self.tile)
            self.smem_bytes = (2 * self._ring_bytes(self.taps)
                               + self.n_slots * self.slot_elems * self.elt)
        else:
            self.taps = next(t for t in STAGE_TAPS
                             if 2 * self._ring_bytes(t) <= SMEM_BYTES)
            self.tile = min((t for t in TILES if self.n_slots * self.elt
                             * self._slot_elems(t) <= 4 * SMEM_BYTES),
                            key=lambda t: self.tile_cost(t, False))
            self.in_shared_memory = False
            self.slot_elems = self._slot_elems(self.tile)
            self.smem_bytes = 2 * self._ring_bytes(self.taps)
        self.ring_bytes = self._ring_bytes(self.taps)

    def executed_flops(self, n, h, w):
        """FLOPs of the products the kernel issues on (n, h, w) input: the
        M tiles of every pass of every tile (past a region's end too), at
        the padded K and N; in f32 each product counted once, not as its
        three TF32 products."""
        tiles = -(-h // self.tile[0]) * -(-w // self.tile[1])
        per_tile = sum(2 * 64 * GROUPS * mt * cin_p
                       * (9 if kind == "conv3" else 1) * nc
                       for kind, cin_p, cout_p, src, dst in self._convs()
                       for nc, mt in self._passes(self.tile, cin_p, cout_p,
                                                  src, dst,
                                                  self.in_shared_memory))
        return n * tiles * per_tile

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
        if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
            x = x.clone()
        out = torch.empty((n, h, w, self.c_out), dtype=self.cdtype,
                          device=x.device)
        th, tw = self.tile
        tiles = -(-h // th) * -(-w // tw)
        grid = min(tiles, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        scratch = None if self.in_shared_memory else torch.empty(
            grid * self.n_slots * self.slot_elems, dtype=self.cdtype,
            device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i in range(n):
            err = _lib().lssvc_conv_chain(
                x[i].data_ptr(), out[i].data_ptr(), self.wmm.data_ptr(),
                self.wdw.data_ptr(), self.biases.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                self._recs, self._slopes, len(self.ops), h, w, self.c_in,
                self.c_out, self.cp[0], self.L, th, tw, self.slot_of[0],
                self.n_slots, self.ring_bytes, self.prefetch,
                self.slot_elems, grid, self.smem_bytes,
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
