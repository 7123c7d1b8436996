"""Spatial (height-axis) partitioning of a single stream over ranks (the
JAX package's `parallel/spatial.py`).

Data parallelism (`parallel/serve.py`) scales throughput with independent
streams; this module splits one frame's height over the ranks of a
process group, so every stage of the two-layer forward runs on H/n rows a
rank:

- Convolutions, pools, pixel shuffles, resizes, pads and bit sums: the
  strip forms of the port's own ops (`ops/strips.py`), which fetch their
  row halos from the neighbouring ranks; a level too short to split is
  computed whole on every rank.  (The JAX package has GSPMD partition
  them.)
- Backward warps: `flow_warp_sharded_auto` / `grouped_warp_sharded_auto`
  fetch `halo` boundary rows from the neighbours (none past the frame's
  top or bottom, where the kernel's clamp at the strip's edge is the
  frame's border clamp) and launch the warp kernel
  (`ops/warp_kernels.py`; the plain warp on the CPU) on the padded strip,
  its vertical flow put on the frame's global rows (`_on_global_rows`), so
  that the strip samples exactly the whole frame's f32 positions: the
  strip's output equals the whole frame's rows bit for bit.  (The JAX
  package pads the frame's edges with repeated rows and samples at
  row + halo, which can flip a near-integer tap; its tests allow 1e-4.)
  A runtime guard takes the exact branch when the global max |flow_y|
  passes the halo: gather the frame, warp it whole with the same kernel,
  keep this rank's rows.  The guard is a Python `if` on the all-reduced
  max.  `flow_warp_spatial` / `grouped_warp_spatial` are the single-hop
  forms with no guard, which refuse a strip shorter than the halo.

The process group takes the place of the JAX package's mesh
(`make_spatial_mesh`); strips are plain tensors holding this rank's rows
(`h_sharding(group).shard(x)` cuts them from a frame, `.gather` joins
them).  Every rank calls every function here with its own strips, in the
same order.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import spatial_ctx, strips
from .mesh import group_or_world, make_mesh


class HSharding:
    """The twin of the JAX package's `h_sharding(mesh)`: NHWC tensors split
    along H over the ranks of `group`, rank r holding rows [r*H/n,
    (r+1)*H/n)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def shard(self, x):
        """This rank's rows of a whole frame (a view)."""
        h = x.shape[1]
        if h % self.world:
            raise ValueError(f"height {h} is not divisible by {self.world} "
                             "ranks")
        rows = h // self.world
        return x[:, self.rank * rows:(self.rank + 1) * rows]

    def gather(self, x):
        """The whole frame from every rank's strip (a collective)."""
        with spatial_ctx.spatial(self.group):
            return strips.gather_rows(x)


def h_sharding(group=None) -> HSharding:
    """NHWC tensors sharded along their height over `group` (the default
    group when None)."""
    return HSharding(group_or_world(group))


def make_spatial_mesh(n=None, backend=None, device="cuda", **kwargs):
    """The process group of the spatial mode (`parallel.mesh.make_mesh`)."""
    return make_mesh(n, backend=backend, device=device, **kwargs)


def make_spatial_forward(group, shape_hr, scale_factor: float = 2.0,
                         pad_size=(0, 0, 0, 0), kernel_warps: bool = False,
                         halo: int = 8, halo_grouped: int = 44,
                         od_offset_cap=None):
    """The two-layer P-frame forward on H-strips over `group`.

    Returns fn(params, x_bl, x_el, dpb) -> (dpb, bit_bl + bit_el), every
    image-like argument and DPB entry this rank's strip (the DPB keys of
    `models/lssvc.py`; the returned DPB feeds the next frame as it is)
    and the bits the whole frame's, equal on every rank.  `params` is the
    flat parameter dict on this rank's device.

    kernel_warps=True routes every warp through the halo-exchange wrappers:
    each rank launches the warp kernel on its own strip, exact whenever
    |flow_y| stays within `halo` (single-flow warps) / `halo_grouped`
    (OffsetDiversity), the exact branch otherwise.  kernel_warps=False
    takes the exact branch always: the whole-frame warp that the JAX
    package's GSPMD path computes.

    The models' mode is the caller's `ops.nn.precision_scope`, as the JAX
    package's is its process-wide mode: every mode has a strip form (its
    GSPMD partitions the packed and s8 convolutions like any other; the
    packed pair store packs after the sharded warp).  Outside any scope
    the mode is fp32 under PyTorch's own backend flags (TF32 convs on the
    card), so a parity run opens `precision_scope(Mode("fp32"))`.
    `od_offset_cap` is the model attribute (None: uncapped, the JAX
    package's default)."""
    from ..models import lssvc as lssvc_model

    group = group_or_world(group)

    def fwd(params, x_bl, x_el, dpb):
        with torch.no_grad(), spatial_ctx.spatial(
                group, halo, halo_grouped, exact_only=not kernel_warps):
            out = lssvc_model.forward_one_frame(
                params, x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
                dpb["ref_feature_bl"], dpb["ref_feature_el"], shape_hr,
                scale_factor, pad_size, od_offset_cap)
            dpb = {k: strips.plain(v) for k, v in out["dpb"].items()}
            return dpb, strips.plain(out["bit_bl"] + out["bit_el"])

    return fwd


def make_spatial_intra_forward(group, shape_hr, pad_size=(0, 0, 0, 0)):
    """The IntraSS two-layer I-frame forward on H-strips (warp-free:
    convs, GDN, resizes and bit sums).  Returns fn(params, bl_params,
    x_bl, x_el) -> (x_hat_el strip, bit_bl + bit_el), `params` the EL's
    keys and `bl_params` the IntraNoAR's (`models/intra_ss.py` `forward`).
    Serving a GOP spatially is this for I-frames and
    `make_spatial_forward` for P-frames; the mode the caller's scope, as
    there."""
    from ..models import intra_ss

    group = group_or_world(group)

    def fwd(params, bl_params, x_bl, x_el):
        with torch.no_grad(), spatial_ctx.spatial(group):
            out = intra_ss.forward(params, bl_params, x_bl, x_el, shape_hr,
                                   pad_size)
            return (strips.plain(out["x_hat_el"]),
                    strips.plain(out["bit_bl"] + out["bit_el"]))

    return fwd


def level_plan(heights, group=None) -> dict:
    """{global rows: split?} of each level height, by `ops.strips.splits`
    (the one rule every op applies)."""
    with spatial_ctx.spatial(group_or_world(group)):
        return {int(h): strips.splits(int(h)) for h in heights}


# --- explicit halo-exchange warps -------------------------------------------


@contextlib.contextmanager
def _on(group):
    """The spatial context on `group` unless it is already active (the
    wrappers are called from the routed warps, and directly)."""
    if spatial_ctx.active() and group is spatial_ctx.GROUP:
        yield
        return
    with spatial_ctx.spatial(group, spatial_ctx.HALO,
                             spatial_ctx.HALO_GROUPED,
                             spatial_ctx.EXACT_ONLY):
        yield


def _halo_rows(rank: int, halo: int):
    """(rows above, rows below) a rank's strip takes: `halo` each side,
    none past the frame's top or bottom, where the kernel's clamp at the
    strip's edge is the frame's own border clamp."""
    return (halo if rank > 0 else 0,
            halo if rank < spatial_ctx.WORLD - 1 else 0)


def _halo_strip(x, halo: int):
    """This rank's strip with its halo rows from the neighbours
    (`strips.fetch_rows`: one exchange, or the whole level gathered for a
    halo deeper than a strip), and (rows above, rows below)."""
    h = x.shape[1]

    def span(r):
        above, below = _halo_rows(r, halo)
        return r * h - above, (r + 1) * h + below

    return strips.fetch_rows(x, span), _halo_rows(spatial_ctx.RANK, halo)


def _edge_pad(t, pads):
    """`t` with its first row repeated pads[0] times above and its last
    pads[1] times below (the flows' and masks' rows for a padded strip:
    only its own rows' outputs are kept)."""
    above, below = pads
    pieces = [t[:, :1].expand(-1, above, *t.shape[2:]), t,
              t[:, -1:].expand(-1, below, *t.shape[2:])]
    return torch.cat(pieces, dim=1) if above or below else t


def _on_global_rows(flow_y):
    """A strip's vertical flow as the whole-frame warp rounds it: the warp
    samples row (row + flow) in f32, which rounds coarser at the frame's
    global rows (a 1080p row's ulp is 1.2e-4 px) than at the strip's.
    (global row + flow) - global row is exact in f32, and a strip's
    padded rows never lie above its global rows (`_halo_rows`), so with
    it the strip samples exactly the whole frame's positions."""
    rows = torch.arange(flow_y.shape[1], dtype=torch.float32,
                        device=flow_y.device) + strips.row_offset(flow_y)
    rows = rows.view(1, -1, *([1] * (flow_y.dim() - 2)))
    return (rows + flow_y.float()) - rows


def _flow_on_global_rows(planes):
    """A flow plane's y component on the global rows (`_on_global_rows`)."""
    (flow,) = planes
    return [torch.stack([flow[..., 0].float(),
                         _on_global_rows(flow[..., 1])], dim=-1)]


def _units_on_global_rows(planes):
    """OffsetDiversity's (flow_x, flow_y, mask) with flow_y on the global
    rows."""
    flow_x, flow_y, mask = planes
    return [flow_x, _on_global_rows(flow_y), mask]


def _own_rows(out, first: int, rows: int):
    if isinstance(out, tuple):
        return tuple(o[:, first:first + rows] for o in out)
    return out[:, first:first + rows]


def _check_shard_height(h_total, n, halo):
    """The single-hop wrappers exchange rows with their immediate
    neighbours only; a strip shorter than the halo cannot supply it (the
    *_sharded_auto wrappers gather deeper halos instead)."""
    if h_total // n < halo:
        raise ValueError(
            f"per-shard height {h_total}//{n}={h_total // n} < halo {halo}: "
            f"single-hop neighbour exchange cannot supply the halo; use the "
            f"*_sharded_auto/_auto variants (multi-hop strip) or fewer shards")


def _sharded(counts, warp, srcs, planes, on_rows, fy, halo, fmax, group):
    """`warp(*srcs, *planes)` on H-strips: the sources' rows and the
    per-pixel planes (flows, mask) of this rank.

    A level held whole warps as it is.  The guard (the all-reduced max
    |fy|, or the caller's bound `fmax`; always the exact branch under
    `spatial_ctx.EXACT_ONLY`) picks the branch: past `halo`, gather the
    frame and the planes, warp them whole, keep this rank's rows;
    within it, warp the sources' halo strips by the planes edge-padded to
    match, their vertical flows on the global rows (`on_rows`), and keep
    the strip's own rows.  One launch either way; `counts` counts the
    branches."""
    with _on(group_or_world(group)):
        if strips.is_whole(planes[0]):
            counts.whole_calls += 1
            return _whole_warp(warp, *srcs, *planes)
        rows = planes[0].shape[1]
        exact = spatial_ctx.EXACT_ONLY or not float(
            strips.global_max(fy.abs()) if fmax is None else fmax) <= halo
        if exact:
            counts.exact_calls += 1
            full = [strips.gather_rows(t) for t in (*srcs, *planes)]
            with spatial_ctx.cleared():
                out = warp(*full)
            return _own_rows(out, spatial_ctx.RANK * rows, rows)
        counts.strip_calls += 1
        padded = [_halo_strip(t, halo) for t in srcs]
        pads = padded[0][1]
        # the global rows need the spatial context: before `cleared`
        planes = [_edge_pad(t, pads) for t in on_rows(planes)]
        with spatial_ctx.cleared():
            out = warp(*(t for t, _ in padded), *planes)
        return _own_rows(out, pads[0], rows)


def _whole_warp(fn, *ts):
    """A warp of tensors the spatial context holds whole: the kernel on them
    as they are."""
    with spatial_ctx.cleared():
        out = fn(*(strips.plain(t) for t in ts))
    if isinstance(out, tuple):
        return tuple(strips.whole(o) for o in out)
    return strips.whole(out)


def _flow_warp(*args):
    from ..ops import warp_kernels as wk

    return wk.flow_warp(*args) if len(args) == 2 else wk.flow_warp_pair(*args)


def _grouped(group_num):
    from ..ops import warp_kernels as wk

    return lambda x, fx, fy, m: wk.grouped_warp(x, fx, fy, m, group_num)


def flow_warp_sharded_auto(x, flow, group=None, halo: int = 8, fmax=None):
    """Backward warp of an H-strip by its flow strip, the warp kernel run on
    this rank's neighbour-padded strip (one launch).

    Correct for any flow: when the global max |flow_y| (all-reduced, or the
    caller's bound `fmax`) passes `halo`, the exact branch gathers the
    frame and the flow, warps them whole (one launch) and keeps this
    rank's rows.  `.strip_calls` / `.exact_calls` count the branches
    taken (`.whole_calls` the warps of a level held whole)."""
    return _sharded(flow_warp_sharded_auto, _flow_warp, (x,), [flow],
                    _flow_on_global_rows, flow[..., 1], halo, fmax, group)


flow_warp_sharded_auto.strip_calls = 0
flow_warp_sharded_auto.exact_calls = 0
flow_warp_sharded_auto.whole_calls = 0


def flow_warp_pair_sharded_auto(a, b, flow, group=None, halo: int = 8,
                                fmax=None):
    """`flow_warp_sharded_auto` of two sources by one flow: one
    `flow_warp_pair` launch on the padded strips (or on the gathered
    frame), counted on `flow_warp_sharded_auto`."""
    return _sharded(flow_warp_sharded_auto, _flow_warp, (a, b), [flow],
                    _flow_on_global_rows, flow[..., 1], halo, fmax, group)


def grouped_warp_sharded_auto(x, flow_x, flow_y, mask, group_num: int,
                              group=None, halo: int = 44):
    """OffsetDiversity's grouped warp on H-strips, the kernel run per rank
    on the padded strip (flows and mask edge-padded, the output's own rows
    kept); runtime-guarded like `flow_warp_sharded_auto`: a global max
    |flow_y| past `halo` takes the exact branch.  Counts on
    `.strip_calls` / `.exact_calls` / `.whole_calls`."""
    return _sharded(grouped_warp_sharded_auto, _grouped(group_num), (x,),
                    [flow_x, flow_y, mask], _units_on_global_rows, flow_y,
                    halo, None, group)


grouped_warp_sharded_auto.strip_calls = 0
grouped_warp_sharded_auto.exact_calls = 0
grouped_warp_sharded_auto.whole_calls = 0


def flow_warp_spatial(x, flow, group=None, halo: int = 8):
    """Backward warp of an H-strip by its flow strip, with no guard: each
    rank takes `halo` rows from its immediate neighbours and warps its own
    rows against the padded strip (counted as a strip call).  Exact
    against the global warp whenever every |flow_y| <= halo (|flow_x| is
    unrestricted: W is not split); refuses a strip shorter than the
    halo."""
    with _on(group_or_world(group)):
        _check_shard_height(x.shape[1] * spatial_ctx.WORLD,
                            spatial_ctx.WORLD, halo)
        return _sharded(flow_warp_sharded_auto, _flow_warp, (x,), [flow],
                        _flow_on_global_rows, flow[..., 1], halo, halo,
                        group)


def grouped_warp_spatial(x, flow_x, flow_y, mask, group_num: int,
                         group=None, halo: int = 44):
    """OffsetDiversity's grouped warp on H-strips with no guard (see
    `flow_warp_spatial`): the source strip padded with `halo` neighbour
    rows, the flows and mask edge-padded to match, the own rows kept."""
    with _on(group_or_world(group)):
        _check_shard_height(x.shape[1] * spatial_ctx.WORLD,
                            spatial_ctx.WORLD, halo)
        return _sharded(grouped_warp_sharded_auto, _grouped(group_num),
                        (x,), [flow_x, flow_y, mask], _units_on_global_rows,
                        flow_y, halo, halo, group)


def reset_counts():
    """Set the branch counts of both sharded warps to 0."""
    for fn in (flow_warp_sharded_auto, grouped_warp_sharded_auto):
        fn.strip_calls = fn.exact_calls = fn.whole_calls = 0


def branch_counts() -> dict:
    return {name: {"strip": fn.strip_calls, "exact": fn.exact_calls,
                   "whole": fn.whole_calls}
            for name, fn in (("flow_warp", flow_warp_sharded_auto),
                             ("grouped_warp", grouped_warp_sharded_auto))}
