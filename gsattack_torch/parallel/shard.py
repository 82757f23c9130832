"""The sharded multi-view render over the (views, splats) mesh. Port of
`gsattack/parallel/pallas_shard.py` (its `shard_map` composition in
PyTorch's SPMD idiom: one process a device, explicit collectives):

- scene tensors are this rank's splat block (replicated across the views
  axis), the camera batch is this rank's view block;
- each rank projects its splat block for its views (elementwise over
  points: no communication);
- the projected per-gaussian arrays (mean2d, conic, opacity, depth, the
  binning radius and the colours, 11 floats a splat, + 16 with the object
  channels) are all-gathered over the splats group in one collective;
- binning and the blend then run on each rank: over a band of tile rows
  when the blend is tile-parallel (1 < splats <= tiles_y), over the whole
  image otherwise. A band is binned as the whole image's binning kept to
  its rows (each gaussian's candidate tiles and the depth keys' precision
  are the whole image's), so that it equals the unsharded render. The
  blend is `ops/raster.py::rasterize_views`, so the CUDA kernels of
  `csrc/blend.cu` on a card;
- the bands and view blocks are gathered into the whole batch on every
  rank, for a loss that every rank computes the same way.

Backward (`parallel/collectives.py`): the image gather keeps each rank's
slice, the projected-array gather reduce-scatters the per-gaussian
gradients back to their splat block (summed over the bands), and the
scene blocks' gradients are summed over the views axis when the views are
sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..ops.project import ProjectedGaussians, project, stack_projections
from ..ops.raster import TILE, _tiles, bin_gaussians, rasterize_views
from .collectives import all_reduce, gather, sum_grads_over
from .mesh import SPLATS_AXIS, VIEWS_AXIS, axis_size
from .shardings import assemble, image_spec, shard_camera_batch


def measure_tile_row_costs(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    rect_candidates: int = 0,
) -> np.ndarray:
    """Per-tile-row valid pair counts of one projected view: the band
    planner's cost vector. One binning pass on the host's schedule; call
    it at set-up over a sample of cameras and sum the results."""
    tiles_x, tiles_y = _tiles(width, height)
    bins = bin_gaussians(
        proj.mean2d, proj.depth, proj.radius_tight, width, height, pairs_per_gaussian,
        conic=proj.conic, opacity=proj.opacity, rect_candidates=rect_candidates,
    )
    counts = (bins.tile_end - bins.tile_start).cpu().numpy().astype(np.int64)
    return counts.reshape(tiles_y, tiles_x).sum(axis=1)


def plan_bands(costs, n_bands: int) -> tuple[int, ...]:
    """Contiguous partition of `len(costs)` tile rows into exactly
    `n_bands` non-empty bands that minimises the largest band cost (the
    exact linear-partition DP, on the host over at most a few hundred
    rows). Returns the rows of each band. With uniform costs it is a
    near-equal split, so it also places the remainder of a tiles_y that
    the band count does not divide."""
    costs = np.asarray(costs, dtype=np.float64)
    t = len(costs)
    if n_bands > t:
        raise ValueError(f"{n_bands} bands over {t} tile rows")
    if n_bands == 1:
        return (t,)
    if costs.sum() <= 0.0:
        costs = np.ones(t)
    s = np.concatenate([[0.0], np.cumsum(costs)])  # s[i] = cost of rows < i
    # f[i] = least largest band cost of rows < i in k bands (k rolls).
    f = np.where(np.arange(t + 1) >= 1, s, np.inf)
    cut = np.zeros((n_bands, t + 1), dtype=np.int64)
    for k in range(2, n_bands + 1):
        g = np.full(t + 1, np.inf)
        for i in range(k, t + 1):
            j = np.arange(k - 1, i)
            cand = np.maximum(f[j], s[i] - s[j])
            a = int(np.argmin(cand))
            g[i], cut[k - 1, i] = cand[a], j[a]
        f = g
    sizes, i = [], t
    for k in range(n_bands, 1, -1):
        j = int(cut[k - 1, i])
        sizes.append(i - j)
        i = j
    sizes.append(i)
    return tuple(reversed(sizes))


def _bands(height: int, n_splats: int, band_tiles):
    """(each band's tile rows, each band's first tile row, the assembled
    bands' row of each image row or None) for a tile-parallel blend."""
    tiles_y = -(-height // TILE)
    if band_tiles is None:
        band_tiles = plan_bands(np.ones(tiles_y), n_splats)
    band_tiles = tuple(int(b) for b in band_tiles)
    if len(band_tiles) != n_splats or sum(band_tiles) != tiles_y or min(band_tiles) < 1:
        raise ValueError(
            f"band_tiles {band_tiles} must be {n_splats} positive counts summing to {tiles_y}"
        )
    starts = np.concatenate([[0], np.cumsum(band_tiles[:-1])]).astype(np.int64)
    band_h = max(band_tiles) * TILE
    row_idx = None
    if band_h * n_splats != height:
        # Uneven bands render at the largest band's height. Global row r
        # lives in band d at d * band_h + (r - starts[d] * TILE); rows past
        # `height` (the ceil-tiling pad) are never gathered.
        d_of = np.repeat(np.arange(n_splats), np.array(band_tiles) * TILE)[:height]
        r = np.arange(height)
        row_idx = d_of * band_h + r - starts[d_of] * TILE
    return band_tiles, starts, row_idx


def render_sharded(
    scene: GaussianScene,
    cams: Camera,
    bg: torch.Tensor,
    mesh,
    pairs_per_gaussian: int = 32,
    chunk: int = 64,
    max_chunks: int = 16,
    rect_candidates: int = 0,
    band_tiles: tuple[int, ...] | None = None,
    with_objects: bool = True,
    return_objects: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> dict:
    """The sharded render of a stacked camera batch, with the counts a
    trainer reads. `scene` is this rank's splat block (`shard_scene`);
    `cams` is the whole batch, every rank passing the same. Returns:

    - `render` (V, H, W, 3), the whole batch on every rank, and with
      `return_objects` the object channels after the RGB ones (V, H, W,
      3 + C_obj); `with_objects` blends them as `rasterize_views` does;
    - `radii` (V_local, N_local), the int screen radii of this rank's
      splats in its views;
    - `num_truncated_pairs`, summed over the whole batch.

    A batch that does not divide the views axis renders on every views
    rank whole (views replicated, splats still sharded). `mean2d_offset`
    (N_local, 2) is added to every view's screen means: a zero tensor
    that requires grad collects their gradient. `band_tiles` gives each
    splats rank its tile rows (one count each, summing to tiles_y;
    `plan_bands(measure_tile_row_costs(...))` balances them by pairs);
    None splits the rows evenly. `backend` and the caps go to every band
    as `rasterize_views` takes them: the tiered bin works on the whole
    image's candidates, the budgets on each band's own pair list and slot
    table, as the reference packs each band."""
    width, height = cams.width, cams.height
    n_views, n_splats = axis_size(mesh, VIEWS_AXIS), axis_size(mesh, SPLATS_AXIS)
    splats_group = mesh.get_group(SPLATS_AXIS)
    views_sharded = n_views > 1 and cams.num_views % n_views == 0
    tile_parallel = 1 < n_splats <= _tiles(width, height)[1]

    if views_sharded:
        cams = shard_camera_batch(cams, mesh)
        group = mesh.get_group(VIEWS_AXIS)
        scene = scene.with_params({k: sum_grads_over(v, group) for k, v in scene.params().items()})
    proj = stack_projections([project(scene, cams.view_at(i)) for i in range(cams.num_views)])
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_offset)

    # One gather of the packed float fields over the splats group. Each
    # band uses every gaussian, so the backward sums the bands' gradients;
    # a replicated blend gives each rank the whole gradient, so it keeps
    # the rank's block. Depth and the binning radius only bin (as in
    # `rasterize_views`): they go detached, so that no zero gradient
    # reaches the radius's sqrt at 0, which is NaN for culled rows.
    fields = [proj.mean2d, proj.conic, proj.opacity[..., None], proj.depth.detach()[..., None],
              proj.radius_tight.detach()[..., None], proj.color]
    fields += [proj.obj] if with_objects else []
    widths = [f.shape[-1] for f in fields]
    packed = gather(torch.cat(fields, dim=-1), splats_group, dim=1, sum_grads=tile_parallel)
    mean2d, conic, opacity, depth, radius_tight, color, *obj = torch.split(packed, widths, dim=-1)
    full = ProjectedGaussians(
        mean2d=mean2d, depth=depth[..., 0], conic=conic, radius=radius_tight[..., 0],
        color=color, obj=obj[0] if with_objects else color[..., :0],
        opacity=opacity[..., 0], radius_tight=radius_tight[..., 0],
    )

    tile_rows, row_idx, pad = None, None, 0
    if tile_parallel:
        # Each splats rank blends its band of tile rows, binned as the whole
        # image's (`bin_gaussians`), then pads it to the largest band's
        # height for the gather.
        bands, starts, row_idx = _bands(height, n_splats, band_tiles)
        j = mesh.get_local_rank(SPLATS_AXIS)
        tile_rows = (int(starts[j]), int(starts[j]) + bands[j])
        pad = (max(bands) - bands[j]) * TILE
    out = rasterize_views(
        full, width, height, bg, pairs_per_gaussian=pairs_per_gaussian, chunk=chunk,
        max_chunks=max_chunks, with_objects=with_objects, rect_candidates=rect_candidates,
        tile_rows=tile_rows, backend=backend, pairs_budget=pairs_budget,
        compact_budget=compact_budget, tier_split=tier_split, heavy_budget=heavy_budget,
    )
    img = torch.cat([out["render"], out["render_object"]], -1) if return_objects else out["render"]
    if pad:
        img = torch.nn.functional.pad(img, (0, 0, 0, 0, 0, pad))
    img = assemble(img, mesh, image_spec(views_sharded, tile_parallel))
    if row_idx is not None:
        img = img.index_select(1, torch.as_tensor(row_idx, device=img.device))

    # Each band and each view block counts its own tiles' truncated pairs.
    truncated = out["num_truncated_pairs"]
    if tile_parallel:
        truncated = all_reduce(truncated, splats_group)
    if views_sharded:
        truncated = all_reduce(truncated, mesh.get_group(VIEWS_AXIS))
    return {"render": img, "radii": proj.radius, "num_truncated_pairs": truncated}


def render_views_sharded(
    scene: GaussianScene,
    cams: Camera,
    bg: torch.Tensor,
    mesh,
    pairs_per_gaussian: int = 32,
    chunk: int = 64,
    max_chunks: int = 16,
    rect_candidates: int = 0,
    band_tiles: tuple[int, ...] | None = None,
    with_objects: bool = True,
    return_objects: bool = False,
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> torch.Tensor:
    """Sharded multi-view render -> (V, H, W, 3) on every rank,
    differentiable with respect to this rank's splat block `scene`
    (`render_sharded` has the arguments)."""
    return render_sharded(
        scene, cams, bg, mesh, pairs_per_gaussian, chunk, max_chunks, rect_candidates,
        band_tiles, with_objects, return_objects, backend=backend, pairs_budget=pairs_budget,
        compact_budget=compact_budget, tier_split=tier_split, heavy_budget=heavy_budget,
    )["render"]
