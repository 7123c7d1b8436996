"""Per-op digests of a forward pass: the first op whose output differs
between the H-strip forward and the whole frame's.

    with OpDigests() as rec:          # on every rank of the strip run
        spatial_forward(...)
    with OpDigests() as ref:          # the unsharded forward
        forward_one_frame(...)
    first_differences(ref.records, [rank0.records, rank1.records])

While open, `OpDigests` wraps the public ops that the models import
(convs, GDN, pools, resizes, the warps, OffsetDiversity's fusion product)
in every module of the package that imported them, and records, for each
outermost call in order, the op's name, its tensor arguments' shapes and a
digest of each output: the float64 sum and sum of squares of each row (H)
of an NHWC tensor.  A strip's digests are its own rows, a whole level's
all of them, so the ranks' digests concatenated along H are the frame's.
The digests are a diagnostic: two outputs with equal digests are taken as
equal (a last-bit change moves a row's float64 sum), and the first op that
differs names the computation whose result depends on the strip.
"""

from __future__ import annotations

import sys

import torch

from ..ops import nn, strips
from ..ops import warp as warp_ops
from ..ops import warp_kernels as wk

# the ops recorded: every op of the model path whose output a strip
# computes from other rows than its own
OPS = (nn.conv2d, nn.conv_transpose2d, nn.gdn, nn.matmul_f32out,
       nn.pixel_shuffle, nn.avg_pool2d, nn.max_pool2d, wk.flow_warp,
       wk.flow_warp_pair, wk.grouped_warp, warp_ops.bilinear_resize,
       warp_ops.bilinear_upsample2, warp_ops.bilinear_downsample2)


def digest(t: torch.Tensor):
    """(whole level?, (2, H) float64: each row's sum and sum of squares);
    a tensor of another rank one (1, 1) sum."""
    whole = strips.is_whole(t)
    d = strips.plain(t).detach().double()
    if d.dim() != 4:
        return True, d.reshape(1, -1).sum(1, keepdim=True).cpu()
    return whole, torch.stack([d.sum(dim=(0, 2, 3)),
                               (d * d).sum(dim=(0, 2, 3))]).cpu()


class OpDigests:
    """A context that records each outermost op call's (name, argument
    shapes, [digest of each output]) in `records`."""

    def __init__(self):
        self.records = []
        self._depth = 0
        self._patched = []

    def _wrap(self, fn):
        def call(*args, **kwargs):
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            if self._depth == 0:
                outs = out if isinstance(out, tuple) else (out,)
                self.records.append((
                    fn.__name__,
                    tuple(tuple(a.shape) for a in args if torch.is_tensor(a)),
                    [digest(o) for o in outs if torch.is_tensor(o)]))
            return out
        return call

    def __enter__(self):
        wrapped = {id(f): (f, self._wrap(f)) for f in OPS}
        for name, mod in list(sys.modules.items()):
            if mod is None or not name.startswith("lssvc_tpu_torch"):
                continue
            for attr, obj in list(vars(mod).items()):
                # the defining module keeps its own function: the kernel
                # wrappers count their launches on it
                if id(obj) in wrapped and obj.__module__ != name:
                    self._patched.append((mod, attr, obj))
                    setattr(mod, attr, wrapped[id(obj)][1])
        return self

    def __exit__(self, *exc):
        for mod, attr, obj in self._patched:
            setattr(mod, attr, obj)
        self._patched = []
        return False


def first_differences(ref, ranks, limit=4):
    """The first `limit` op outputs of the strip run (`ranks`: each rank's
    records, in rank order) whose digests differ from the whole frame's
    (`ref`): [{"op": index, "name", "shapes" (the frame's arguments),
    "rank_shapes" (rank 0's), "output", "rows", "of_rows",
    "max_rel_row_sum"}], or one {"error": ...} where the runs called other
    ops."""
    if any(len(r) != len(ref) for r in ranks):
        return [{"error": f"op counts {len(ref)} (frame) and "
                          f"{[len(r) for r in ranks]} (ranks)"}]
    found = []
    for i, (name, shapes, outs) in enumerate(ref):
        if any(r[i][0] != name for r in ranks):
            return found + [{"error": f"op {i}: {name} against "
                                      f"{[r[i][0] for r in ranks]}"}]
        for j, (_, want) in enumerate(outs):
            parts = [r[i][2][j] for r in ranks]
            got = parts[0][1] if parts[0][0] else torch.cat(
                [p[1] for p in parts], dim=1)
            if got.shape == want.shape and torch.equal(got, want):
                continue
            entry = {"op": i, "name": name, "shapes": shapes,
                     "rank_shapes": ranks[0][i][1], "output": j}
            if got.shape != want.shape:
                entry["digest_shapes"] = [tuple(got.shape), tuple(want.shape)]
            else:
                entry.update(
                    rows=int((got != want).any(0).sum()),
                    of_rows=int(want.shape[1]),
                    max_rel_row_sum=float(((got - want).abs()
                                           / want.abs().clamp_min(1e-30))
                                          .max()))
            found.append(entry)
        if len(found) >= limit:
            break
    return found[:limit]
