"""Tile-based differentiable rasterization: pair binning, the blend, and the
`rasterize` / `rasterize_views` entry points.

Port of `gsattack/ops/raster.py`. The steps:

1. **Pair expansion.** Every Gaussian emits up to `pairs_per_gaussian`
   (tile, depth, index) candidates over its tile rect, each kept only if
   the exact ellipse test says the tile can see alpha >= 1/255.
2. **One packed-key sort.** (tile, depth) packs into one integer key, as
   the reference does: the tile takes ceil(log2(T+2)) high bits of 32 and
   the squashed depth d/(d+1) the rest. The key is held in int64 because
   torch has no general uint32 sort; its value is the reference's uint32.
   Only valid pairs are sorted: the reference's invalid pairs carry the
   sentinel tile and sort past every range, so the ranges are the same.
3. **Per-tile ranges** with `searchsorted`.
4. **Blend.** Front to back per 16x16 tile with the reference's exact
   rules (alpha capped at 0.99, skipped below 1/255 and where the power is
   positive, a pixel stops before its T would cross 1e-4). CUDA tensors go
   to the hand-written kernels of `ops/blend.py`; CPU tensors go to
   `blend_tiles_plain`, which is also the oracle the kernels are held to.

Each tile blends at most `chunk * max_chunks` pairs, on both routes; the
pairs past that cap are counted in `num_truncated_pairs`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import blend as blend_cuda
from .project import ProjectedGaussians

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class TileBins(NamedTuple):
    gauss_idx: torch.Tensor  # (P,) int32 depth-sorted pair -> gaussian index
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_end: torch.Tensor  # (num_tiles,) int32
    num_culled_pairs: torch.Tensor  # () int64 pairs dropped by the static cap


def _tiles(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _tile_rect(mean2d, radius, tiles_x, tiles_y):
    """Tile index ranges covered by the radius bbox. The exclusive bound is
    floor(v / TILE) + 1: the CUDA original's integer ceil trick
    undercounts the last tile for float centres and radii."""
    r = radius.to(torch.float32)

    def bound(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    rmin_x = bound(torch.floor((mean2d[:, 0] - r) / TILE), tiles_x)
    rmax_x = bound(torch.floor((mean2d[:, 0] + r) / TILE) + 1, tiles_x)
    rmin_y = bound(torch.floor((mean2d[:, 1] - r) / TILE), tiles_y)
    rmax_y = bound(torch.floor((mean2d[:, 1] + r) / TILE) + 1, tiles_y)
    return rmin_x, rmax_x, rmin_y, rmax_y


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _box_quad_min(a, b, c, lx, ux, ly, uy):
    """Exact min of the PD quadratic a dx^2 + 2b dx dy + c dy^2 over the box
    [lx, ux] x [ly, uy]: 0 if the origin is inside, else the least of the
    four edges' clamped 1D vertices."""
    inside = (lx <= 0.0) & (ux >= 0.0) & (ly <= 0.0) & (uy >= 0.0)
    c_s = torch.clamp(c, min=1e-12)
    a_s = torch.clamp(a, min=1e-12)

    def q(x, y):
        return a * x * x + 2.0 * b * x * y + c * y * y

    def edge_x(x):  # dx fixed, dy free
        return q(x, _clip(-b * x / c_s, ly, uy))

    def edge_y(y):  # dy fixed, dx free
        return q(_clip(-b * y / a_s, lx, ux), y)

    qe = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(ux)),
        torch.minimum(edge_y(ly), edge_y(uy)),
    )
    return torch.where(inside, torch.zeros_like(qe), qe)


def _candidate_cells(mean2d, radius, conic, opacity, tiles_x, tiles_y, c_rect):
    """Per-gaussian rect-enumeration cells with the exact ellipse test:
    (tile_id (N, c_rect) with the num_tiles sentinel on invalid cells,
    valid (N, c_rect), touched (N,))."""
    num_tiles = tiles_x * tiles_y
    rmin_x, rmax_x, rmin_y, rmax_y = _tile_rect(mean2d, radius, tiles_x, tiles_y)
    rect_w = rmax_x - rmin_x
    touched = torch.where(
        radius > 0, rect_w * (rmax_y - rmin_y), torch.zeros_like(rect_w)
    )

    j = torch.arange(c_rect, dtype=torch.int32, device=mean2d.device)[None, :]
    w_safe = torch.clamp(rect_w, min=1)[:, None]
    tx = rmin_x[:, None] + j % w_safe
    ty = rmin_y[:, None] + torch.div(j, w_safe, rounding_mode="floor")
    valid = j < touched[:, None]
    if conic is not None:
        # Tile pixel centres span [t*TILE, t*TILE + TILE-1] in each axis.
        lx = (tx * TILE).to(torch.float32) - mean2d[:, 0:1]
        ly = (ty * TILE).to(torch.float32) - mean2d[:, 1:2]
        qmin = _box_quad_min(
            conic[:, 0:1], conic[:, 1:2], conic[:, 2:3],
            lx, lx + (TILE - 1.0), ly, ly + (TILE - 1.0),
        )
        # alpha_max = op exp(-qmin/2) >= 1/255  <=>  qmin <= 2 ln(255 op),
        # with 1e-3 of slack for f32 rounding (the blend decides those).
        q_cut = (2.0 * torch.log(torch.clamp(opacity * 255.0, min=1e-6)) + 1e-3)[:, None]
        pd = (conic[:, 0:1] > 0.0) & (conic[:, 2:3] > 0.0)
        valid &= (qmin <= q_cut) | ~pd  # non-PD conic: keep (blend decides)
    tile_id = torch.where(valid, ty * tiles_x + tx, torch.full_like(tx, num_tiles))
    return tile_id, valid, touched


@torch.no_grad()
def bin_gaussians(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    conic: torch.Tensor | None = None,
    opacity: torch.Tensor | None = None,
    rect_candidates: int = 0,
    tile_rows: tuple[int, int] | None = None,
) -> TileBins:
    """Depth-sorted per-tile index lists for one view.

    `radius` is the binning radius (pass `radius_tight`). With `conic` and
    `opacity` given, every candidate tile passes the exact ellipse test.
    `rect_candidates` (>= pairs_per_gaussian, needs conic+opacity)
    enumerates the rect at that many cells, packs the survivors left, and
    keeps the first `pairs_per_gaussian`; 0 disables it. Candidates past a
    capacity are counted in `num_culled_pairs`.

    `tile_rows` = (r0, r1) bins a band: the whole image's binning kept to
    tile rows r0 <= row < r1, its tiles numbered from the band's first
    (rows past the image are empty). Each gaussian's candidate cells and
    the sort key's depth precision are the whole image's, so that a band's
    tiles list the same gaussians in the same order as the whole image's,
    the pairs-per-gaussian cap and depth ties included. `num_culled_pairs`
    is then still the whole image's count."""
    mean2d, depth, radius = mean2d.detach(), depth.detach(), radius.detach()
    do_ellipse = conic is not None and opacity is not None
    if do_ellipse:
        conic, opacity = conic.detach(), opacity.detach()
    else:
        conic = opacity = None
    n = mean2d.shape[0]
    dev = mean2d.device
    tiles_x, tiles_y = _tiles(width, height)
    num_tiles = tiles_x * tiles_y
    c = pairs_per_gaussian
    compact = do_ellipse and 0 < c <= rect_candidates
    c_rect = rect_candidates if compact else c

    tile_id, valid, touched = _candidate_cells(
        mean2d, radius, conic, opacity, tiles_x, tiles_y, c_rect
    )
    overflow = torch.clamp(touched - c_rect, min=0).to(torch.int64)
    if compact:
        # Pack survivors left in enumeration order and keep c columns.
        j = torch.arange(c_rect, dtype=torch.int32, device=dev)[None, :]
        skey = torch.where(valid, j, torch.full_like(j, c_rect))
        skey, order = torch.sort(skey, dim=1, stable=True)
        tile_id = torch.gather(tile_id, 1, order)
        overflow = overflow + torch.clamp(valid.sum(dim=1) - c, min=0)
        tile_id = tile_id[:, :c]
        valid = skey[:, :c] < c_rect

    nbits_tile = max(int(math.ceil(math.log2(num_tiles + 2))), 1)
    if tile_rows is not None:
        r0, r1 = tile_rows
        valid = valid & (tile_id >= r0 * tiles_x) & (tile_id < r1 * tiles_x)
        tile_id = tile_id - r0 * tiles_x
        num_tiles = (r1 - r0) * tiles_x
    depth_bits = 32 - nbits_tile
    q = torch.clamp(depth / (depth + 1.0), 0.0, 1.0 - 1e-7)
    dq = torch.clamp(
        (q * float(2.0**depth_bits)).to(torch.int64), max=2**depth_bits - 1
    )
    gidx = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, c)
    key = (tile_id.to(torch.int64) << depth_bits) | dq[:, None]
    key, gidx = key[valid], gidx[valid]
    sorted_key, order = torch.sort(key, stable=True)
    sorted_gidx = gidx[order]
    tids = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(sorted_key, tids << depth_bits, side="left").to(
        torch.int32
    )
    return TileBins(sorted_gidx, bounds[:-1], bounds[1:], overflow.sum())


@torch.no_grad()
def auto_pairs_per_gaussian(
    proj: ProjectedGaussians, width: int, height: int, quantum: int = 4, floor: int = 4
) -> int:
    """The per-gaussian pair capacity from the view's largest tile
    footprint, rounded up to `quantum`."""
    tiles_x, tiles_y = _tiles(width, height)
    rmin_x, rmax_x, rmin_y, rmax_y = _tile_rect(
        proj.mean2d, proj.radius_tight, tiles_x, tiles_y
    )
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    touched = torch.where(proj.radius_tight > 0, area, torch.zeros_like(area))
    m = max(int(touched.max()) if touched.numel() else 0, floor)
    return ((m + quantum - 1) // quantum) * quantum


def blend_tiles_plain(
    gauss_idx: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    colors: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    chunk: int,
    max_chunks: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch blend, the port of the reference's `_blend_tiles`: all
    tiles of all views at once, `chunk` pairs at a time, with the
    log-space within-chunk transmittance. Its autograd is the backward.

    gauss_idx (P,) indexes the flattened (V*N) gaussians; tile_start and
    tile_end (V, tiles) are offsets into it. mean2d (V, N, 2), conic
    (V, N, 3), opacity (V, N) and colors (V, N, CH) are per view. Returns
    image (V, H_pad, W_pad, CH) and final transmittance (V, H_pad, W_pad),
    H_pad = tiles_y * 16 and W_pad = tiles_x * 16."""
    v, n, n_ch = colors.shape
    dev = colors.device
    num_tiles = tiles_x * tiles_y
    p = TILE * TILE
    pair_geom = torch.cat(
        [mean2d, conic, opacity[..., None]], dim=-1
    ).reshape(v * n, 6)
    pair_col = colors.reshape(v * n, n_ch)
    start = tile_start.reshape(-1).to(torch.int64)  # (M,) M = V * tiles
    end = tile_end.reshape(-1).to(torch.int64)
    m = start.shape[0]

    tid = torch.arange(num_tiles, device=dev).repeat(v)
    pix = torch.arange(p, device=dev)
    pxf = ((tid % tiles_x)[:, None] * TILE + pix[None, :] % TILE).to(torch.float32)
    pyf = ((tid // tiles_x)[:, None] * TILE + pix[None, :] // TILE).to(torch.float32)
    pxf, pyf = pxf[:, None, :], pyf[:, None, :]  # (M, 1, P)

    lane = torch.arange(chunk, device=dev)

    def chunk_step(k, accum, T, done, pair_geom, pair_col):
        idx = start[:, None] + k * chunk + lane[None, :]  # (M, K)
        pair_valid = idx < end[:, None]
        gid = gauss_idx[idx.clamp(max=max(gauss_idx.shape[0] - 1, 0))].to(torch.int64)
        gid = torch.where(pair_valid, gid, torch.zeros_like(gid))
        geom = pair_geom[gid]  # (M, K, 6)
        col = pair_col[gid]  # (M, K, CH)

        dx = pxf - geom[..., 0:1]  # (M, K, P)
        dy = pyf - geom[..., 1:2]
        power = (
            -0.5 * (geom[..., 2:3] * dx * dx + geom[..., 4:5] * dy * dy)
            - geom[..., 3:4] * dx * dy
        )
        # Clamp before exp so overflowing lanes cannot make inf * 0 = NaN.
        # torch.minimum splits the gradient at a tie as jnp.minimum does.
        zero = power.new_zeros(())
        alpha = torch.minimum(
            geom[..., 5:6] * torch.exp(torch.minimum(power, zero)),
            power.new_tensor(ALPHA_MAX),
        )
        use = (power <= 0.0) & (alpha >= ALPHA_MIN) & pair_valid[..., None]
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))

        # Inclusive within-chunk transmittance (log-space cumprod).
        log1m = torch.log1p(-alpha)
        t_incl = T[:, None, :] * torch.exp(torch.cumsum(log1m, dim=1))
        frozen = (t_incl < T_EPS) | done[:, None, :]
        alpha_eff = torch.where(frozen, torch.zeros_like(alpha), alpha)

        log1m_eff = torch.log1p(-alpha_eff)
        cum_eff = torch.cumsum(log1m_eff, dim=1)
        t_exc = T[:, None, :] * torch.exp(cum_eff - log1m_eff)
        w = alpha_eff * t_exc  # (M, K, P)
        accum = accum + torch.bmm(w.transpose(1, 2), col)  # (M, P, CH)
        T = T * torch.exp(cum_eff[:, -1, :])
        done = done | torch.any((t_incl < T_EPS) & use, dim=1)
        return accum, T, done

    accum = torch.zeros((m, p, n_ch), dtype=torch.float32, device=dev)
    T = torch.ones((m, p), dtype=torch.float32, device=dev)
    done = torch.zeros((m, p), dtype=torch.bool, device=dev)
    count = (end - start).clamp(min=0)
    n_loop = min(max_chunks, -(-int(count.max()) // chunk)) if m else 0
    for k in range(n_loop):
        # Recomputed in the backward, as the reference's jax.checkpoint
        # does: only the carries are kept per chunk.
        accum, T, done = checkpoint(
            chunk_step, k, accum, T, done, pair_geom, pair_col, use_reentrant=False
        )

    img = accum.reshape(v, tiles_y, tiles_x, TILE, TILE, n_ch)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(v, tiles_y * TILE, tiles_x * TILE, n_ch)
    Tm = T.reshape(v, tiles_y, tiles_x, TILE, TILE)
    Tm = Tm.permute(0, 1, 3, 2, 4).reshape(v, tiles_y * TILE, tiles_x * TILE)
    return img, Tm


def blend_tiles(
    gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
    tiles_x: int, tiles_y: int, chunk: int, max_chunks: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The blend by device: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors. Arguments as `blend_tiles_plain`."""
    if colors.device.type == "cuda":
        return blend_cuda.blend(
            gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
            tiles_x, tiles_y, chunk * max_chunks,
        )
    return blend_tiles_plain(
        gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
        tiles_x, tiles_y, chunk, max_chunks,
    )


def bin_views(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    rect_candidates: int = 0,
    tile_rows: tuple[int, int] | None = None,
) -> TileBins:
    """Bin every view of a view-stacked projection into one flat pair list:
    gauss_idx indexes the flattened (V*N) gaussians, the tile ranges
    (V, tiles) are offsets into the list, and the culled count is summed
    over views. `tile_rows` as in `bin_gaussians`."""
    v, n = proj.mean2d.shape[:2]
    idx, starts, ends, culled = [], [], [], []
    offset = 0
    for vi in range(v):
        b = bin_gaussians(
            proj.mean2d[vi], proj.depth[vi], proj.radius_tight[vi], width,
            height, pairs_per_gaussian, conic=proj.conic[vi],
            opacity=proj.opacity[vi], rect_candidates=rect_candidates, tile_rows=tile_rows,
        )
        idx.append(b.gauss_idx + vi * n)
        starts.append(b.tile_start + offset)
        ends.append(b.tile_end + offset)
        culled.append(b.num_culled_pairs)
        offset += b.gauss_idx.shape[0]
    return TileBins(
        torch.cat(idx).to(torch.int32),
        torch.stack(starts),
        torch.stack(ends),
        torch.stack(culled).sum(),
    )


def rasterize_views(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg: torch.Tensor,
    pairs_per_gaussian: int = 32,
    chunk: int = 64,
    max_chunks: int = 16,
    with_objects: bool = True,
    rect_candidates: int = 0,
    tile_rows: tuple[int, int] | None = None,
) -> dict:
    """Multi-view rasterization of a view-stacked projection (leading view
    dimension on every field): each view is binned, and the whole batch
    blends in one launch over a (tiles, views) grid.

    `tile_rows` = (r0, r1) renders the band of tile rows r0 <= row < r1 of
    the (width, height) image, (r1 - r0) * 16 rows high: binned as the
    whole image's (`bin_gaussians`), blended with the screen means moved
    up by the band's first row (a translation leaves EWA splatting
    unchanged).

    `with_objects=False` blends RGB only and returns `render_object`
    zero-filled. Returns `render` (V, H, W, 3), `render_object`
    (V, H, W, C_obj), `final_transmittance` (V, H, W), and the counts
    `num_culled_pairs` and `num_truncated_pairs` summed over views."""
    tiles_x, tiles_y = _tiles(width, height)
    channels = torch.cat([proj.color, proj.obj], dim=-1) if with_objects else proj.color
    n_ch = channels.shape[-1]
    bins = bin_views(proj, width, height, pairs_per_gaussian, rect_candidates, tile_rows)
    mean2d = proj.mean2d
    if tile_rows is not None:
        tiles_y = tile_rows[1] - tile_rows[0]
        height = tiles_y * TILE
        mean2d = mean2d - mean2d.new_tensor([0.0, float(tile_rows[0] * TILE)])
    img, T = blend_tiles(
        bins.gauss_idx, bins.tile_start, bins.tile_end, mean2d,
        proj.conic, proj.opacity, channels, tiles_x, tiles_y, chunk, max_chunks,
    )
    img = img[:, :height, :width]
    T = T[:, :height, :width]
    num_truncated = torch.clamp(
        (bins.tile_end - bins.tile_start).to(torch.int64) - chunk * max_chunks, min=0
    ).sum()
    bg_full = torch.cat([bg, bg.new_zeros(n_ch - bg.shape[0])])
    img = img + T[..., None] * bg_full
    obj_img = (
        img[..., 3:]
        if with_objects
        else img.new_zeros(img.shape[:3] + (proj.obj.shape[-1],))
    )
    return {
        "render": img[..., :3],
        "render_object": obj_img,
        "final_transmittance": T,
        "num_culled_pairs": bins.num_culled_pairs,
        "num_truncated_pairs": num_truncated,
    }


def rasterize(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg: torch.Tensor,
    pairs_per_gaussian: int = 32,
    chunk: int = 64,
    max_chunks: int = 16,
    with_objects: bool = True,
    rect_candidates: int = 0,
) -> dict:
    """Single-view rasterization: `rasterize_views` on a batch of one.
    Returns `render` (H, W, 3), `render_object` (H, W, C_obj),
    `final_transmittance` (H, W), `num_culled_pairs` and
    `num_truncated_pairs`."""
    out = rasterize_views(
        ProjectedGaussians(*(f[None] for f in proj)), width, height, bg,
        pairs_per_gaussian, chunk, max_chunks, with_objects, rect_candidates,
    )
    for key in ("render", "render_object", "final_transmittance"):
        out[key] = out[key][0]
    return out
