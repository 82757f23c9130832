"""The (views, splats) device mesh over `torch.distributed`: the port of
`gsattack/parallel/`. `mesh.py` joins the process group and builds the
mesh, `shardings.py` places the scene, cameras and images on it,
`collectives.py` holds the collectives with their gradients, and
`shard.py` is the sharded render."""

from .mesh import (
    SPLATS_AXIS,
    VIEWS_AXIS,
    initialize_distributed,
    local_mesh_shape,
    make_mesh,
    run_local,
)
from .shard import measure_tile_row_costs, plan_bands, render_sharded, render_views_sharded
from .shardings import (
    CAMERA_SPEC,
    SCENE_SPEC,
    gather_scene,
    pad_to_multiple,
    shard_camera_batch,
    shard_points,
    shard_scene,
)

__all__ = [
    "VIEWS_AXIS",
    "SPLATS_AXIS",
    "initialize_distributed",
    "local_mesh_shape",
    "make_mesh",
    "run_local",
    "SCENE_SPEC",
    "CAMERA_SPEC",
    "pad_to_multiple",
    "shard_scene",
    "shard_points",
    "gather_scene",
    "shard_camera_batch",
    "measure_tile_row_costs",
    "plan_bands",
    "render_sharded",
    "render_views_sharded",
]
