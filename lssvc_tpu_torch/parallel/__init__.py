from .mesh import make_mesh, replicate, shard_batch
from .scheduler import run_tasks
from .spatial import (
    flow_warp_sharded_auto,
    flow_warp_spatial,
    grouped_warp_sharded_auto,
    grouped_warp_spatial,
    h_sharding,
    make_spatial_forward,
    make_spatial_mesh,
)
