"""H-strips: the port's ops on a frame whose height is split over ranks.

The JAX package gets its spatial mode from GSPMD, which partitions every
convolution, resize and reduction of an H-sharded program and inserts the
halo exchanges itself.  PyTorch has no such partitioner (DTensor's
convolution takes only width-sharded stride-1 convs), so while
`ops.spatial_ctx` is active the port's own ops call the strip forms here.

A level of the network (a tensor's global height G) is split over the n
ranks when n divides G; rank r then holds rows [r*G/n, (r+1)*G/n) as a
plain tensor.  A level too short to split (the BL hyperprior of a 1080p
frame on 2 ranks, 9 rows; EL 128 on 4 ranks at 1/64, 2 rows) is computed
whole on every rank and held as a `Whole` tensor, a subclass that every
torch op propagates, so that the ops can tell a 9-row strip of an 18-row
level from a whole 9-row level.  The rule (`splits`) is one function of
the level's height and the rank count, the same for every op; an op whose
output lies on another level (a strided conv, a pool, a pixel shuffle, a
resize, a pad) gathers, computes and slices as the two levels' rules say.

Every strip form fetches the global input rows its output rows read
(`fetch_rows`): its own rows, boundary rows of its neighbours by one
`all_gather` of each rank's top and bottom slabs, and zero or edge rows
outside the frame; a halo deeper than a strip gathers the whole level
instead.  On a `gloo` group a CUDA tensor is staged through the host
(`utils/collectives.py`, chosen by the group's backend).

Bit sums (`global_sum`) add the ranks' partial sums; a level computed
whole is counted once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils import collectives
from . import spatial_ctx


class Whole(torch.Tensor):
    """A tensor of a level computed whole on every rank."""


def plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, Whole) else t


def whole(t):
    return t.as_subclass(Whole)


def is_whole(t) -> bool:
    return isinstance(t, Whole)


def splits(rows: int) -> bool:
    """Whether a level of `rows` global rows is split over the ranks."""
    n = spatial_ctx.WORLD
    return rows % n == 0 and rows >= n


def out_rows(rows: int, rank: int | None = None):
    """(first, end) global rows a rank holds of a level of `rows` rows: its
    strip if the level is split, else all of them."""
    if not splits(rows):
        return 0, rows
    r = spatial_ctx.RANK if rank is None else rank
    h = rows // spatial_ctx.WORLD
    return r * h, (r + 1) * h


def global_rows(t) -> int:
    """The global height of a strip or a whole tensor (the tensor's own
    height outside the spatial context)."""
    if not spatial_ctx.active() or is_whole(t):
        return t.shape[1]
    return t.shape[1] * spatial_ctx.WORLD


def row_offset(t) -> int:
    """The global row of a tensor's first row."""
    if not spatial_ctx.active() or is_whole(t):
        return 0
    return spatial_ctx.RANK * t.shape[1]


def as_level(t, rows: int):
    """A tensor holding this rank's rows of a level of `rows` rows: `t`
    holds exactly them (a plain tensor for a split level, marked whole
    otherwise)."""
    return plain(t) if splits(rows) else whole(t)


def level_of(full, rows: int):
    """This rank's part of a level computed whole (`full` holds all
    `rows` rows): its strip, or all of it marked whole."""
    first, end = out_rows(rows)
    return as_level(full[:, first:end], rows)


# ---------------------------------------------------------------------------
# collectives

def all_gather(t) -> list:
    """Every rank's `t` (equal shapes), in rank order."""
    return collectives.all_gather(plain(t), spatial_ctx.GROUP)


def all_reduce(t, op=dist.ReduceOp.SUM):
    """`t` reduced over the ranks (a new tensor)."""
    return collectives.all_reduce(plain(t), spatial_ctx.GROUP, op)


def gather_rows(t):
    """The whole level of a strip (all ranks' rows in order); a whole
    tensor as it is.  Plain."""
    if is_whole(t):
        return plain(t)
    return torch.cat(all_gather(t), dim=1)


def global_sum(t):
    """sum(t) over the whole level: the ranks' partial sums added, or a
    whole level's sum once.  Outside the spatial context torch.sum."""
    s = torch.sum(plain(t))
    if not spatial_ctx.active() or is_whole(t):
        return s
    return all_reduce(s)


def level_max(t):
    """max(t) over the whole level, a 0-d tensor (torch.amax outside the
    spatial context)."""
    m = torch.amax(plain(t))
    if spatial_ctx.active() and not is_whole(t):
        m = all_reduce(m, dist.ReduceOp.MAX)
    return m


def global_max(t) -> float:
    """max(t) over the whole level, as a Python float."""
    return float(level_max(t).float())


# ---------------------------------------------------------------------------
# row fetching

def _fill_rows(like, count, fill, edge_row):
    shape = (like.shape[0], count) + tuple(like.shape[2:])
    if fill == "edge":
        return edge_row.expand(shape)
    return like.new_full(shape, float(fill))


def fetch_rows(t, span, fill=0.0):
    """Global rows [a, b) = span(rank) of a strip or whole tensor `t` as a
    plain tensor: rows past the frame are `fill` (a value, or "edge" for
    the nearest border row).  `span(r)` gives every rank's (a, b), so all
    ranks agree on the exchange: one all_gather of each rank's bottom rows
    (for the rank below) and top rows (for the rank above), the deepest any
    rank needs; none when no rank reads past its strip; the whole level
    when some rank reads past its neighbours' strips."""
    rank = spatial_ctx.RANK
    a, b = span(rank)
    g = global_rows(t)
    if is_whole(t):
        lo, ext = 0, plain(t)
    else:
        h = t.shape[1]
        up = down = 0
        for r in range(spatial_ctx.WORLD):
            ar, br = span(r)
            up = max(up, r * h - max(ar, 0))
            down = max(down, min(br, g) - (r + 1) * h)
        if up > h or down > h:
            lo, ext = 0, gather_rows(t)
        elif up == down == 0:
            lo, ext = rank * h, t
        else:
            slab = torch.cat([t[:, :down], t[:, h - up:]], dim=1)
            parts = all_gather(slab)
            pieces = [t]
            lo = rank * h
            if rank > 0:
                pieces.insert(0, parts[rank - 1][:, down:])
                lo -= up
            if rank < spatial_ctx.WORLD - 1:
                pieces.append(parts[rank + 1][:, :down])
            ext = torch.cat(pieces, dim=1)
    first, end = max(a, 0), min(b, g)
    mid = ext[:, first - lo:end - lo]
    top, bottom = max(0, min(b, 0) - a), max(0, b - max(a, g))
    if top == bottom == 0:
        return mid
    pieces = [mid]
    if top:
        pieces.insert(0, _fill_rows(ext, top, fill, ext[:, :1]))
    if bottom:
        pieces.append(_fill_rows(ext, bottom, fill, ext[:, -1:]))
    return torch.cat(pieces, dim=1)


# ---------------------------------------------------------------------------
# strip forms of the ops

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_rows(x, kh: int, stride_h: int, pad_h, local):
    """A row-windowed op (a conv, a pool) on strips: output row o reads
    input rows [stride_h*o - pad_top, stride_h*o - pad_top + kh), zero rows
    past the frame.  `local(x_rows)` computes the output rows from exactly
    the rows they read, with no padding along H."""
    pt, pb = pad_h
    g = global_rows(x)
    g_out = (g + pt + pb - kh) // stride_h + 1

    def span(r):
        o0, o1 = out_rows(g_out, r)
        return stride_h * o0 - pt, stride_h * (o1 - 1) - pt + kh

    return as_level(local(fetch_rows(x, span)), g_out)


# The routes of a conv on strips, cheapest first:
#   "strip"  a conv of the rows the rank's output rows read (its strip and
#            the halo), no padding along H;
#   "embed"  those rows and `EXTRA_ROWS` more on either side, placed at
#            their rows of a zeroed tensor of the level's height, convolved
#            as the frame is;
#   "level"  the whole level gathered and convolved as the frame is: the
#            frame's own call on the frame's rows.
ROUTES = ("strip", "embed", "level")
# rows past the reach that "embed" fetches: a tile of the largest
# Winograd transform, 6 output rows of a 3x3 conv, reads 8 input rows
EXTRA_ROWS = 8
# the route of each call shape, and each route's calls since
# `reset_route_calls`
_ROUTE_OF: dict = {}
_ROUTE_CALLS = dict.fromkeys(ROUTES, 0)


def reset_route_calls():
    for route in ROUTES:
        _ROUTE_CALLS[route] = 0


def route_counts() -> dict:
    """{route: {"shapes": call shapes taking it, "calls": its calls since
    `reset_route_calls`}}, and for the routes past "strip" "convs": each
    shape's (level rows, weight shape)."""
    out = {route: {"shapes": 0, "calls": _ROUTE_CALLS[route]}
           for route in ROUTES}
    for key, route in _ROUTE_OF.items():
        out[route]["shapes"] += 1
        if route != "strip":
            out[route].setdefault("convs", []).append((key[0], key[5]))
    return out


def _aligned(t):
    # contiguous and 16-byte aligned: cuDNN's choice reads the layout and
    # the pointers' alignment too, so the probe and the run see the same
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv2d(x, w, b, stride, padding, groups, frame_conv, mode):
    """`ops.nn.conv2d` on strips: this rank's output rows, the same bits as
    those rows of the frame's conv.  `padding` is (ph, pw) or ((top,
    bottom), (left, right)); `frame_conv(x, w, b, stride, padding,
    groups)` is the unsplit conv; `mode` keys what else it reads (the
    precision and the backend flags).

    cuDNN picks a conv's algorithm, and with it the order of each output's
    sums, by the call's shape: a strip-shaped call may sum some rows in
    another order than the frame's call (other last bits, which the model
    amplifies), and a tiled or FFT algorithm's rows depend on rows past the
    conv's reach.  So the first call of each shape probes the routes
    (`ROUTES`) on random rows of the level's shape (the algorithm is
    chosen by shape, not by value): the cheapest route whose rows equal the
    frame's conv of the same rows bit for bit on every rank is taken from
    then on; "level", the frame's own call, is the last resort."""
    (pt, pb), (pl, pr) = (_pair(p) for p in padding)
    kh, sh = w.shape[2], _pair(stride)[0]
    g = global_rows(x)
    g_out = (g + pt + pb - kh) // sh + 1
    if is_whole(x) and not splits(g_out):
        return whole(frame_conv(plain(x), w, b, stride, padding, groups))
    strip_pad = (0, pl) if pl == pr else ((0, 0), (pl, pr))

    def reach(r, extra):
        o0, o1 = out_rows(g_out, r)
        a, e = sh * o0 - pt, sh * (o1 - 1) - pt + kh
        return (a, e) if extra is None else (max(a - extra, 0),
                                             min(e + extra, g))

    def framed(rows, a):
        # the frame's conv of `rows` (global rows from `a`) placed in a
        # zeroed level: this rank's output rows of it
        if rows.shape[1] == g:
            frame = _aligned(rows)
        else:
            frame = rows.new_zeros((rows.shape[0], g, *rows.shape[2:]))
            frame[:, a:a + rows.shape[1]] = rows
        out = frame_conv(frame, w, b, stride, padding, groups)
        o0, o1 = out_rows(g_out)
        return out if o1 - o0 == g_out else out[:, o0:o1].clone()

    spans = {"strip": lambda r: reach(r, None),
             "embed": lambda r: reach(r, EXTRA_ROWS),
             "level": lambda r: (0, g)}
    convs = {"strip": lambda rows, a: frame_conv(
                 _aligned(rows), w, b, stride, strip_pad, groups),
             "embed": framed, "level": framed}
    key = (g, x.shape[0], tuple(x.shape[2:]), x.dtype, x.device.type,
           tuple(w.shape), w.dtype, b is None, _pair(stride),
           ((pt, pb), (pl, pr)), groups, mode, spatial_ctx.WORLD,
           spatial_ctx.RANK)
    route = _ROUTE_OF.get(key)
    if route is None:
        route = _ROUTE_OF[key] = _probe(x, g, spans, convs)
    _ROUTE_CALLS[route] += 1
    rows = gather_rows(x) if route == "level" else fetch_rows(x, spans[route])
    a = max(spans[route](spatial_ctx.RANK)[0], 0)
    return as_level(convs[route](rows, a), g_out)


def _probe(x, g, spans, convs) -> str:
    """The first route whose rows equal the frame's conv bit for bit on
    every rank, on random rows of `x`'s level (the ranks agree by one
    reduction a route tried)."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    with torch.no_grad():
        level = whole(torch.randn((x.shape[0], g, *x.shape[2:]),
                                  generator=gen, dtype=x.dtype,
                                  device=x.device))
        want = convs["level"](plain(level), 0)
        for route in ROUTES[:-1]:
            span = spans[route]
            got = convs[route](fetch_rows(level, span),
                               max(span(spatial_ctx.RANK)[0], 0))
            bad = torch.tensor([int(not torch.equal(got, want))],
                               device=x.device)
            if not int(all_reduce(bad, dist.ReduceOp.MAX)):
                return route
    return "level"


def pool2d(x, k: int, local_pool):
    """A k x k, stride-k pool on strips."""
    return conv_rows(x, k, k, (0, 0), local_pool)


def pixel_shuffle(x, r: int, local_shuffle):
    """Row-local, but its output is another level: a whole input whose
    output level is split keeps this rank's rows."""
    out = local_shuffle(plain(x), r)
    g_out = global_rows(x) * r
    if is_whole(x):
        return level_of(out, g_out)
    return out


def pad(x, pad_lrtb, value, local_pad):
    """`ops.nn.pad_nhwc` on strips: W padded locally, H at the frame's top
    and bottom (rows shifted between ranks where the level's split moves)."""
    left, right, top, bottom = pad_lrtb
    if top == bottom == 0:
        out = local_pad(plain(x), (left, right, 0, 0), value)
        return whole(out) if is_whole(x) else out
    g_out = global_rows(x) + top + bottom

    def span(r):
        o0, o1 = out_rows(g_out, r)
        return o0 - top, o1 - top

    rows = fetch_rows(x, span, value)
    return as_level(local_pad(rows, (left, right, 0, 0), value), g_out)


def upsample2(x, local_up):
    """2x bilinear (border clamp) on strips: one input row of context each
    side, edge rows past the frame, the extra output rows cropped."""
    g_out = 2 * global_rows(x)

    def span(r):
        o0, o1 = out_rows(g_out, r)
        return o0 // 2 - 1, (o1 - 1) // 2 + 2

    a, _ = span(spatial_ctx.RANK)
    o0, o1 = out_rows(g_out)
    up = local_up(fetch_rows(x, span, "edge"))
    return as_level(up[:, o0 - 2 * a:o1 - 2 * a], g_out)


def downsample2(x, local_down):
    """0.5x bilinear (a mean of row pairs) on strips."""
    return conv_rows(x, 2, 2, (0, 0), local_down)


def resize_rows(x, mat: np.ndarray, local_resize):
    """Rows of a dense (out, in) resize matrix on strips: this rank's
    output rows take the matrix's rows for them times the input rows those
    rows touch.  `local_resize(rows, m)` applies the (o1-o0, b-a) block
    `m` along H and the width resize."""
    g_out = mat.shape[0]

    def span(r):
        o0, o1 = out_rows(g_out, r)
        cols = np.nonzero(np.any(mat[o0:o1] != 0, axis=0))[0]
        return int(cols[0]), int(cols[-1]) + 1

    a, b = span(spatial_ctx.RANK)
    o0, o1 = out_rows(g_out)
    rows = fetch_rows(x, span)
    return as_level(local_resize(rows, mat[o0:o1, a:b]), g_out)
