"""Process-group helpers (the JAX package's `parallel/mesh.py`, in
PyTorch's idiom: a process group where JAX has a `Mesh`).

Data parallelism over sequences or training items: each rank holds the
replicated parameters and its rows of the global batch; the gradient
average is one collective a step (`parallel/train.py`).  A rank is one
process; `torchrun` (`python -m torch.distributed.run`) starts them and
says so through its environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or a caller names the rank,
the world size and the rendezvous (`init_method`) itself.

The backend is `nccl` for ranks on the card and `gloo` on the CPU.  NCCL
takes one card a rank: more ranks on a host than cards raises, and two
ranks sharing one card take `--backend gloo`, whose collectives stage
CUDA tensors through the host (`utils/collectives.py`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils import collectives


def launched() -> bool:
    """Whether torchrun (or a caller's environment) names this process's
    rank and world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` for "cuda"
    (ranks on one host take their cards in turn), else `device`."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n: int | None = None, backend: str | None = None,
              device="cuda", rank: int | None = None,
              world: int | None = None, init_method: str | None = None):
    """Start or join the default process group and return the group of its
    first `n` ranks (all of them by default).

    The rank, world size and rendezvous come from the arguments or, where
    an argument is None, from torchrun's environment (`env://`).  The
    backend defaults to nccl for "cuda" and gloo for "cpu"; nccl with more
    ranks on this host than cards raises."""
    if not dist.is_initialized():
        backend = backend or default_backend(device)
        if rank is None or world is None:
            if not launched():
                raise RuntimeError(
                    "make_mesh: no RANK / WORLD_SIZE in the environment "
                    "(start the ranks with torchrun) and no rank and world "
                    "given")
            rank = int(os.environ["RANK"]) if rank is None else rank
            world = int(os.environ["WORLD_SIZE"]) if world is None else world
        if backend == "nccl":
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            cards = torch.cuda.device_count()
            if local_world > cards:
                raise ValueError(
                    f"nccl takes one card a rank: {local_world} ranks on "
                    f"this host, {cards} card(s); run the ranks with "
                    "--backend gloo to share a card")
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    size = dist.get_world_size()
    if n is None or n == size:
        return dist.group.WORLD
    if not 0 < n <= size:
        raise ValueError(f"make_mesh({n}): the world has {size} ranks")
    return dist.new_group(list(range(n)))


def group_or_world(group=None):
    """`group`, or the default group when None."""
    return group if group is not None else dist.group.WORLD


def world_of(group=None) -> tuple[int, int]:
    """(rank, world size) in `group` (the default group when None); (0, 1)
    without a process group."""
    if not dist.is_initialized():
        return 0, 1
    group = group_or_world(group)
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(batch, group=None, axis: int = 0):
    """This rank's rows of a global batch, rows [r*b, (r+1)*b) along
    `axis` with b = B / world (a tensor or a dict of them; a value that is
    not a tensor, or a 0-d one, is kept whole).  A data-parallel run so
    takes exactly the items a one-process run of the global batch takes."""
    rank, world = world_of(group)

    def rows(t):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        total = t.shape[axis]
        if total % world:
            raise ValueError(f"batch of {total} along axis {axis} does not "
                             f"split over {world} ranks")
        b = total // world
        return t.narrow(axis, rank * b, b)

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def replicate(tensors, group=None):
    """Rank 0's values broadcast into every rank's tensors, in place (a
    tensor, or a dict of them); returned."""
    if not dist.is_initialized():
        return tensors
    group = group_or_world(group)
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0
    items = tensors.values() if isinstance(tensors, dict) else [tensors]
    for t in items:
        collectives.broadcast_(t, group, src)
    return tensors
