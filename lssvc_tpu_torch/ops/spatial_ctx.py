"""The active spatial-partitioning context (the JAX package's
`ops/spatial_ctx.py`).

While a process group is set here, the port's ops compute on H-strips: a
rank holds rows [rank * h, (rank + 1) * h) of every tensor whose level it
splits (`ops/strips.py`), and `ops.warp_kernels.flow_warp` /
`flow_warp_pair` / `grouped_warp` route through the halo-exchange wrappers
of `parallel/spatial.py`: each rank gathers `halo` boundary rows from its
neighbours and launches the warp on its own strip.  The JAX package reads
its flag at trace time; here it is read at every call, so the context
wraps the calls themselves (`parallel.spatial.make_spatial_forward` enters
it around each frame).

`exact_only` makes every warp take the exact branch (gather the frame,
warp it whole, keep this rank's rows): the whole-frame warp that the JAX
package's GSPMD path computes when `kernel_warps` is off.

A leaf module, so that `ops.warp_kernels` need not import
`parallel.spatial` when it loads (`parallel.spatial` imports the ops).
"""

from __future__ import annotations

import contextlib

GROUP = None
WORLD = 1
RANK = 0
HALO = 8          # single-flow warps: must bound |flow_y|
HALO_GROUPED = 44  # OffsetDiversity units (offsets are 40*tanh-bounded)
EXACT_ONLY = False


def active() -> bool:
    return GROUP is not None


@contextlib.contextmanager
def spatial(group, halo: int = 8, halo_grouped: int = 44,
            exact_only: bool = False):
    """Compute on H-strips over the process group `group` (the default
    group when None is not what is meant: pass the group itself)."""
    import torch.distributed as dist

    global GROUP, WORLD, RANK, HALO, HALO_GROUPED, EXACT_ONLY
    prev = (GROUP, WORLD, RANK, HALO, HALO_GROUPED, EXACT_ONLY)
    GROUP, HALO, HALO_GROUPED, EXACT_ONLY = group, halo, halo_grouped, \
        exact_only
    WORLD = dist.get_world_size(group)
    RANK = dist.get_rank(group)
    try:
        yield
    finally:
        GROUP, WORLD, RANK, HALO, HALO_GROUPED, EXACT_ONLY = prev


@contextlib.contextmanager
def cleared():
    """Route nothing inside the per-strip warp body (recursion guard); the
    strip forms of the ops are off there too."""
    global GROUP
    prev = GROUP
    GROUP = None
    try:
        yield
    finally:
        GROUP = prev
