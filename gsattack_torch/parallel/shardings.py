"""How the scene, the camera batch and the images lie on the (views,
splats) mesh. Port of `gsattack/parallel/shardings.py`.

A spec is the tuple of (mesh axis, tensor dim) pairs that cut a tensor;
an axis that is not named replicates it:

- **scene**: every per-point tensor shards its leading N dimension over
  splats and is replicated over views. Projection and its backward are
  elementwise over N, so this axis needs no communication until the
  projected arrays are gathered for binning;
- **camera batch**: the leading view dimension shards over views (data
  parallelism) and is replicated over splats;
- **images** (V, H, W, C): views over views, and H over splats when the
  blend is tile-parallel (`parallel/shard.py`).

Each rank holds plain tensors: its own block (`local_part`). Capacity is
padded with dead splats to a multiple of the splats axis first, as the
JAX package's `scene.pad_to` does before a sharded render.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera
from ..core.scene import PARAM_NAMES, GaussianScene
from .collectives import all_gather, gather, split
from .mesh import SPLATS_AXIS, VIEWS_AXIS, axis_size

SCENE_SPEC = ((SPLATS_AXIS, 0),)
CAMERA_SPEC = ((VIEWS_AXIS, 0),)


def image_spec(views_sharded: bool, tile_parallel: bool) -> tuple:
    """(V, H, W, C) images: views over views when the batch is sharded,
    H over splats when the blend is tile-parallel."""
    return ((VIEWS_AXIS, 0),) * views_sharded + ((SPLATS_AXIS, 1),) * tile_parallel


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_part(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's part of a tensor that every rank holds whole: for each
    (axis, dim) of `spec`, the rank's block of dim along that axis. The
    gradient of `x` is gathered back whole on every rank
    (`collectives.split`)."""
    for axis, dim in spec:
        x = split(x, mesh.get_group(axis), dim)
    return x


def assemble(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor on every rank from each rank's part (the inverse
    of `local_part`), for a loss that every rank then computes the same
    way: the backward keeps this rank's part of the whole gradient
    (`collectives.gather` with `sum_grads=False`)."""
    for axis, dim in spec:
        x = gather(x, mesh.get_group(axis), dim, sum_grads=False)
    return x


def shard_scene(scene: GaussianScene, mesh) -> GaussianScene:
    """This rank's block of the scene: capacity padded with dead splats to
    a multiple of the splats axis, then every per-point tensor placed by
    `SCENE_SPEC`."""
    scene = scene.pad_to(pad_to_multiple(scene.num_points, axis_size(mesh, SPLATS_AXIS)))
    return scene.replace(**{
        name: local_part(getattr(scene, name), mesh, SCENE_SPEC)
        for name in PARAM_NAMES + ("alive",)
    })


def shard_points(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a per-point tensor, zero-padded to a multiple
    of the splats axis like `shard_scene`'s capacity."""
    pad = pad_to_multiple(x.shape[0], axis_size(mesh, SPLATS_AXIS)) - x.shape[0]
    x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
    return local_part(x, mesh, SCENE_SPEC)


def gather_scene(scene: GaussianScene, mesh, num_points: int | None = None) -> GaussianScene:
    """The whole scene on every rank from each rank's block (no gradient),
    cut back to `num_points` rows when given (the padding dropped)."""
    group = mesh.get_group(SPLATS_AXIS)
    return scene.replace(**{
        name: all_gather(getattr(scene, name).detach(), group)[:num_points]
        for name in PARAM_NAMES + ("alive",)
    })


def shard_camera_batch(cams: Camera, mesh) -> Camera:
    """This rank's views of a stacked camera batch (`CAMERA_SPEC`);
    the view count must divide by the views axis."""
    nv = axis_size(mesh, VIEWS_AXIS)
    if cams.num_views % nv:
        raise ValueError(f"{cams.num_views} views do not divide over {nv} view ranks")
    return dataclasses.replace(cams, **{
        name: local_part(getattr(cams, name), mesh, CAMERA_SPEC)
        for name in ("view", "full_proj", "cam_center", "tanfovx", "tanfovy")
    })
