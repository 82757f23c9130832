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

5. **Backward.** The blend's backward gives one gradient row per sorted
   pair, and each gaussian's rows are summed in a fixed order over the
   binning's (N, c) slot table (`TileBins.slot_table`, the inverse of the
   sort's permutation): `ops/gather_sum.py`, on both routes.

The static caps of the reference's Pallas route (`backend="pallas"`) are
ported as what they do, not as its packed layout: each is a mask on the
bins or the slot table, and every pair it drops is counted.

- `tier_split` / `heavy_budget` (the tiered bin, needs row compaction): a
  gaussian with more than `tier_split` survivors is heavy; the heavy ones
  past the first `heavy_budget` (in index order) lose their columns past
  `tier_split` (counted in `num_culled_pairs`). The reference's virtual
  ids and two-tier tables only lay the same result out for the TPU.
- `pairs_budget`: each tile's pair count is rounded up to a multiple of
  `CHUNK`, the tiles are laid end to end, and the pairs that lie past
  `ceil(pairs_budget / CHUNK) * CHUNK` are dropped from the forward and
  the backward (a clamp of `tile_end`).
- `compact_budget`: a pair kept by the budget whose sorted index is at or
  past `ceil(compact_budget / CHUNK) * CHUNK` keeps its forward
  contribution and loses its gradient (its slot-table entry is -1).

The last two are counted in `num_truncated_pairs`, with the tiles' pairs
past the per-tile cap. The probes `auto_*` size every cap from a view's
binned pair counts, slab by slab, as the reference's do.

Binning runs in the span `render/bin` and the blend in `render/blend`
(`utils/profiling.py`); `bin_views` adds its sorted pairs to the counter
`pairs_binned`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import annotate_fn, count
from . import blend as blend_cuda
from .gather_sum import gather_sum_rows
from .project import ProjectedGaussians

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
# The reference's Pallas pair quantum: the budgets round to it, and the
# "pallas" backend caps a tile at max_chunks * CHUNK pairs.
CHUNK = 128
BACKENDS = ("xla", "pallas")


class TileBins(NamedTuple):
    gauss_idx: torch.Tensor  # (P,) int32 depth-sorted pair -> gaussian index
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_end: torch.Tensor  # (num_tiles,) int32, clamped by pairs_budget
    num_culled_pairs: torch.Tensor  # () int64 pairs dropped by the static caps
    # (N, c) int32: each gaussian's kept columns as positions in the sorted
    # pair list, -1 where a column holds no pair or one without a gradient.
    slot_table: torch.Tensor | None = None
    # () int64 pairs dropped by pairs_budget and compact_budget.
    num_dropped_pairs: torch.Tensor | None = None


def _quantum(budget: int) -> int:
    return (budget + CHUNK - 1) // CHUNK * CHUNK


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
@annotate_fn("render/bin")
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
    tier_split: int = 0,
    heavy_budget: int = 0,
    pairs_budget: int = 0,
    compact_budget: int = 0,
) -> TileBins:
    """Depth-sorted per-tile index lists for one view, and the slot table.

    `radius` is the binning radius (pass `radius_tight`). With `conic` and
    `opacity` given, every candidate tile passes the exact ellipse test.
    `rect_candidates` (>= pairs_per_gaussian, needs conic+opacity)
    enumerates the rect at that many cells, packs the survivors left, and
    keeps the first `pairs_per_gaussian`; 0 disables it. Candidates past a
    capacity are counted in `num_culled_pairs`.

    `tier_split` / `heavy_budget` (both > 0, row compaction on) cap the
    heavy gaussians' columns past the split; `pairs_budget` and
    `compact_budget` (> 0) cap the sorted list and the backward (the
    module docstring has each cap). Their drops are counted in
    `num_culled_pairs` (the tier) and `num_dropped_pairs` (the budgets).

    `tile_rows` = (r0, r1) bins a band: the whole image's binning kept to
    tile rows r0 <= row < r1, its tiles numbered from the band's first
    (rows past the image are empty). Each gaussian's candidate cells (the
    tier included) and the sort key's depth precision are the whole
    image's, so that a band's tiles list the same gaussians in the same
    order as the whole image's, the pairs-per-gaussian cap and depth ties
    included. `num_culled_pairs` is then still the whole image's count;
    the budgets apply to the band's own list, as the reference packs each
    band."""
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
        if 0 < tier_split < c and heavy_budget > 0:
            # Heavy gaussians ranked in index order; those past the budget
            # (clamped to n, as the reference clamps it) keep only their
            # first tier_split columns.
            count = valid.sum(dim=1)
            heavy = count > tier_split
            rank = torch.cumsum(heavy.to(torch.int64), 0) - 1
            over = heavy & (rank >= min(heavy_budget, n))
            overflow = overflow + torch.where(over, count - tier_split, 0)
            valid[:, tier_split:] &= ~over[:, None]

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
    tile_start, tile_end = bounds[:-1], bounds[1:]

    # The slot table: the inverse of the sort's permutation, by column.
    p = sorted_key.shape[0]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(p, dtype=order.dtype, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if pairs_budget > 0:
        # Tiles laid end to end at CHUNK-rounded counts; what lies past
        # the capacity is dropped.
        counts = (tile_end - tile_start).to(torch.int64)
        padded = (counts + CHUNK - 1) // CHUNK * CHUNK
        start_raw = torch.cumsum(padded, 0) - padded
        kept = torch.minimum((_quantum(pairs_budget) - start_raw).clamp(min=0), counts)
        tile_end = tile_start + kept.to(torch.int32)
        dropped = dropped + (counts - kept).sum()
    if pairs_budget > 0 or compact_budget > 0:
        s = torch.arange(p, dtype=torch.int64, device=dev)
        live = s < tile_end.to(torch.int64)[sorted_key >> depth_bits]
        if compact_budget > 0:
            in_capacity = live
            live = live & (s < _quantum(compact_budget))
            dropped = dropped + (in_capacity & ~live).sum()
        pos = torch.where(live[pos], pos, -1)
    table = torch.full((n, c), -1, dtype=torch.int32, device=dev)
    table[valid] = pos.to(torch.int32)
    return TileBins(sorted_gidx, tile_start, tile_end, overflow.sum(), table, dropped)


def slot_table_of(gauss_idx: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                  num_gaussians: int) -> torch.Tensor:
    """A slot table for any pair list: (num_gaussians, c) int32, each
    gaussian's pairs that lie in a tile's range [tile_start, tile_end), in
    list order, -1 past them; c is the most any gaussian has (at least 1).
    `bin_gaussians` gives its own; this serves pair lists built
    otherwise."""
    dev = gauss_idx.device
    p = gauss_idx.shape[0]
    start = tile_start.reshape(-1).to(torch.int64).clamp(0, p)
    end = torch.maximum(tile_end.reshape(-1).to(torch.int64).clamp(0, p), start)
    edge = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    edge.index_add_(0, start, torch.ones_like(start))
    edge.index_add_(0, end, -torch.ones_like(end))
    in_range = torch.cumsum(edge, 0)[:p] > 0
    ids = torch.where(in_range, gauss_idx.to(torch.int64), num_gaussians)
    sorted_ids, order = torch.sort(ids, stable=True)
    counts = torch.bincount(sorted_ids, minlength=num_gaussians + 1)[:num_gaussians]
    c = max(int(counts.max()) if num_gaussians else 0, 1)
    first = torch.cumsum(counts, 0) - counts
    keep = sorted_ids < num_gaussians
    g = sorted_ids[keep]
    rank = torch.arange(p, device=dev)[keep] - first[g]
    table = torch.full((num_gaussians, c), -1, dtype=torch.int32, device=dev)
    table[g, rank] = order[keep].to(torch.int32)
    return table


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


@torch.no_grad()
def _probe_pair_stats(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    c: int,
    rect_candidates: int,
    slab: int = 1 << 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Slab-wise cap probe of one view: (each gaussian's kept survivors
    (N,), each tile's kept pairs (num_tiles,)), as `bin_gaussians` keeps
    them (the first c survivors in enumeration order), without the
    N x c candidate list or its sort: a slab of `slab` splats at a time."""
    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = _tiles(width, height)
    num_tiles = tiles_x * tiles_y
    c_rect = rect_candidates if 0 < c <= rect_candidates else c
    counts = np.empty(n, np.int32)
    hist = np.zeros(num_tiles, np.int64)
    for a in range(0, n, slab):
        b = min(a + slab, n)
        tile_id, valid, _ = _candidate_cells(
            proj.mean2d[a:b].detach(), proj.radius_tight[a:b].detach(),
            proj.conic[a:b].detach(), proj.opacity[a:b].detach(), tiles_x, tiles_y, c_rect,
        )
        kept = valid & (torch.cumsum(valid.to(torch.int32), dim=1) <= c)
        counts[a:b] = kept.sum(dim=1).cpu().numpy()
        cells = torch.where(kept, tile_id, num_tiles).reshape(-1).to(torch.int64)
        hist += torch.bincount(cells, minlength=num_tiles + 1)[:num_tiles].cpu().numpy()
    return counts, hist


def auto_pairs_budget(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    margin: float = 1.25,
    rect_candidates: int = 0,
) -> int:
    """`pairs_budget` from one view's binned pair counts, each tile's
    rounded up to CHUNK, with `margin` and one CHUNK of headroom, rounded
    to CHUNK. Pass the run's `rect_candidates`, so that the probe bins as
    the run does. Host-side; call once at set-up."""
    _, hist = _probe_pair_stats(proj, width, height, pairs_per_gaussian, rect_candidates)
    padded_total = int(((hist + CHUNK - 1) // CHUNK).sum() * CHUNK)
    return _quantum(int(padded_total * margin) + CHUNK)


def auto_compact_budget(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    margin: float = 1.25,
    rect_candidates: int = 0,
) -> int:
    """`compact_budget` from one view's valid pair count, with `margin`
    and one CHUNK of headroom, rounded to CHUNK. Host-side."""
    _, hist = _probe_pair_stats(proj, width, height, pairs_per_gaussian, rect_candidates)
    return _quantum(int(int(hist.sum()) * margin) + CHUNK)


def auto_pair_caps(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    quantum: int = 2,
    floor: int = 2,
) -> tuple[int, int]:
    """Both row-compaction capacities, (pairs_per_gaussian,
    rect_candidates): the most cells of a gaussian that survive the
    ellipse test and its largest rect footprint, each rounded up to
    `quantum`. Host-side; take the max over cameras."""
    rect = auto_pairs_per_gaussian(proj, width, height, quantum, floor)
    counts, _ = _probe_pair_stats(proj, width, height, rect, rect)
    keep = max(int(counts.max()) if counts.size else 0, floor)
    keep = ((keep + quantum - 1) // quantum) * quantum
    return min(keep, rect), rect


def auto_heavy_budget(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int,
    rect_candidates: int,
    tier_split: int,
    margin: float = 1.6,
    quantum: int = 1024,
) -> int:
    """`heavy_budget` for a fixed `tier_split` from one view's survivor
    counts (margin and quantum as in `auto_tier_caps`). Callers that pick
    one split for many views size it from every view at that split."""
    counts, _ = _probe_pair_stats(proj, width, height, pairs_per_gaussian, rect_candidates)
    hb = int(int((counts > tier_split).sum()) * margin) + quantum
    return ((hb + quantum - 1) // quantum) * quantum


def auto_tier_caps(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int,
    rect_candidates: int,
    margin: float = 1.6,
    quantum: int = 1024,
) -> tuple[int, int]:
    """The tiered bin's `(tier_split, heavy_budget)` from one view's
    survivor counts: the split c1 that minimises the flat candidate count
    N * c1 + heavy(c1) * margin * (c - c1), the heavy capacity with
    `margin`. (0, 0) when it does not pay (under a 20% cut) or does not
    apply (no row compaction). Host-side."""
    c = pairs_per_gaussian
    if not (0 < c <= rect_candidates):
        return 0, 0
    n = proj.mean2d.shape[0]
    counts, _ = _probe_pair_stats(proj, width, height, c, rect_candidates)
    best = (n * c, 0, 0)
    for c1 in range(1, c):
        hb = int(int((counts > c1).sum()) * margin) + quantum
        hb = ((hb + quantum - 1) // quantum) * quantum
        flat = n * c1 + hb * (c - c1)
        if flat < best[0]:
            best = (flat, c1, hb)
    if best[0] > 0.8 * n * c:
        return 0, 0
    return best[1], best[2]


def auto_caps(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    margin: float = 1.0,
) -> tuple[int, int, int, int, tuple[int, int]]:
    """Every static cap of a single-view workload in one call:
    (pairs_per_gaussian, rect_candidates, pairs_budget, compact_budget,
    (tier_split, heavy_budget)). rect stays at pairs when the tier pays,
    and is 0 when neither the tier nor compaction does anything."""
    pairs, rect = auto_pair_caps(proj, width, height)
    tier = auto_tier_caps(proj, width, height, pairs, rect)
    if tier == (0, 0) and rect <= pairs:
        rect = 0
    budget = auto_pairs_budget(proj, width, height, pairs, margin=margin, rect_candidates=rect)
    compact = auto_compact_budget(proj, width, height, pairs, margin=margin,
                                  rect_candidates=rect)
    return pairs, rect, budget, compact, tier


CAP_FIELDS = ("pairs_per_gaussian", "rect_candidates", "pairs_budget", "compact_budget",
              "tier_split", "heavy_budget")


def resolve_caps(views, pairs_per_gaussian: int, rect_candidates: int, pairs_budget: int,
                 compact_budget: int, tier_split: int, heavy_budget: int,
                 log=print) -> dict:
    """The attack driver's -1 settings sized from the binned geometry of
    `views`, a list of (single-view projection, width, height), each cap
    the max over the views, as the reference's `run_dagger` sizes them:
    `pairs_per_gaussian` and `rect_candidates` together by
    `auto_pair_caps` (rect 0 when it would be below pairs), or pairs alone
    by `auto_pairs_per_gaussian` (rect -1 then means 0); `pairs_budget` by
    `auto_pairs_budget`; `compact_budget` by `auto_compact_budget` at a
    1.25 margin; `tier_split` by `auto_tier_caps` when row compaction is
    on, with `heavy_budget` measured again at the chosen split on every
    view, and rect set to 0 where it equals pairs and the tier is off.
    A `heavy_budget` of -1 left after that turns the tier off (0), as it
    does in the reference. Returns the six settings by name."""
    caps = dict(zip(CAP_FIELDS, (pairs_per_gaussian, rect_candidates, pairs_budget,
                                 compact_budget, tier_split, heavy_budget)))
    if min(caps[k] for k in CAP_FIELDS[:5]) < 0:
        pairs, rect = caps["pairs_per_gaussian"], caps["rect_candidates"]
        if pairs < 0 and rect < 0:
            measured = [auto_pair_caps(p, w, h) for p, w, h in views]
            pairs = max(k for k, _ in measured)
            rect = max(r for _, r in measured)
            if rect < pairs:
                rect = 0
            log(f"[Info] Auto-sized pairs_per_gaussian = {pairs}, rect_candidates = {rect}")
        elif pairs < 0:
            pairs = max(auto_pairs_per_gaussian(p, w, h) for p, w, h in views)
            log(f"[Info] Auto-sized pairs_per_gaussian = {pairs}")
        elif rect < 0:
            rect = 0
        caps.update(pairs_per_gaussian=pairs, rect_candidates=rect)
        if caps["pairs_budget"] < 0:
            caps["pairs_budget"] = max(
                auto_pairs_budget(p, w, h, pairs, rect_candidates=rect) for p, w, h in views
            )
            log(f"[Info] Auto-sized pairs_budget = {caps['pairs_budget']}")
        if caps["compact_budget"] < 0:
            caps["compact_budget"] = max(
                auto_compact_budget(p, w, h, pairs, margin=1.25, rect_candidates=rect)
                for p, w, h in views
            )
            log(f"[Info] Auto-sized compact_budget = {caps['compact_budget']}")
        if caps["tier_split"] < 0:
            ts = hb = 0
            if 0 < pairs <= rect:
                # One split for every view, the largest; the heavy capacity
                # measured at that split on every view.
                ts = max(auto_tier_caps(p, w, h, pairs, rect)[0] for p, w, h in views)
                if ts:
                    hb = max(auto_heavy_budget(p, w, h, pairs, rect, ts) for p, w, h in views)
            if ts == 0 and rect == pairs:
                caps["rect_candidates"] = 0  # the identity left-pack with no tier
            caps.update(tier_split=ts, heavy_budget=hb)
            if ts:
                log(f"[Info] Auto-sized tier_split = {ts}, heavy_budget = {hb}")
    if caps["heavy_budget"] < 0:
        caps["heavy_budget"] = 0
    return caps


class _PairRows(torch.autograd.Function):
    """Per-gaussian rows gathered to the sorted pairs, `rows[gauss_idx]`,
    whose backward sums each gaussian's pair rows over the slot table."""

    @staticmethod
    def forward(ctx, rows, gauss_idx, slot_table):
        ctx.save_for_backward(slot_table)
        return rows[gauss_idx.long()]

    @staticmethod
    def backward(ctx, d_pair):
        (slot_table,) = ctx.saved_tensors
        return gather_sum_rows(d_pair.contiguous(), slot_table), None, None


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
    slot_table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch blend, the port of the reference's `_blend_tiles`: all
    tiles of all views at once, `chunk` pairs at a time, with the
    log-space within-chunk transmittance. Its autograd is the backward:
    per sorted pair, then summed by gaussian over `slot_table` (V * N, c)
    as the kernels do (`slot_table_of` the pair list when not given).

    gauss_idx (P,) indexes the flattened (V*N) gaussians; tile_start and
    tile_end (V, tiles) are offsets into it. mean2d (V, N, 2), conic
    (V, N, 3), opacity (V, N) and colors (V, N, CH) are per view. Returns
    image (V, H_pad, W_pad, CH) and final transmittance (V, H_pad, W_pad),
    H_pad = tiles_y * 16 and W_pad = tiles_x * 16."""
    v, n, n_ch = colors.shape
    dev = colors.device
    num_tiles = tiles_x * tiles_y
    p = TILE * TILE
    if slot_table is None:
        slot_table = slot_table_of(gauss_idx, tile_start, tile_end, v * n)
    rows = torch.cat([mean2d, conic, opacity[..., None], colors], dim=-1).reshape(v * n, -1)
    pair_rows = _PairRows.apply(rows, gauss_idx, slot_table)  # (P, 6 + CH)
    start = tile_start.reshape(-1).to(torch.int64)  # (M,) M = V * tiles
    end = tile_end.reshape(-1).to(torch.int64)
    m = start.shape[0]

    tid = torch.arange(num_tiles, device=dev).repeat(v)
    pix = torch.arange(p, device=dev)
    pxf = ((tid % tiles_x)[:, None] * TILE + pix[None, :] % TILE).to(torch.float32)
    pyf = ((tid // tiles_x)[:, None] * TILE + pix[None, :] // TILE).to(torch.float32)
    pxf, pyf = pxf[:, None, :], pyf[:, None, :]  # (M, 1, P)

    lane = torch.arange(chunk, device=dev)

    def chunk_step(k, accum, T, done, pair_rows):
        idx = start[:, None] + k * chunk + lane[None, :]  # (M, K)
        pair_valid = idx < end[:, None]
        # Lanes past a tile's end read some other pair; `use` drops them.
        vals = pair_rows[idx.clamp(max=max(pair_rows.shape[0] - 1, 0))]  # (M, K, 6 + CH)
        geom, col = vals[..., :6], vals[..., 6:]

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
            chunk_step, k, accum, T, done, pair_rows, use_reentrant=False
        )

    img = accum.reshape(v, tiles_y, tiles_x, TILE, TILE, n_ch)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(v, tiles_y * TILE, tiles_x * TILE, n_ch)
    Tm = T.reshape(v, tiles_y, tiles_x, TILE, TILE)
    Tm = Tm.permute(0, 1, 3, 2, 4).reshape(v, tiles_y * TILE, tiles_x * TILE)
    return img, Tm


@annotate_fn("render/blend")
def blend_tiles(
    gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
    tiles_x: int, tiles_y: int, chunk: int, max_chunks: int, slot_table=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The blend by device: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors. Arguments as `blend_tiles_plain`."""
    if colors.device.type == "cuda":
        return blend_cuda.blend(
            gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
            tiles_x, tiles_y, chunk * max_chunks, slot_table,
        )
    return blend_tiles_plain(
        gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
        tiles_x, tiles_y, chunk, max_chunks, slot_table,
    )


@annotate_fn("render/bin")
def bin_views(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    pairs_per_gaussian: int = 32,
    rect_candidates: int = 0,
    tile_rows: tuple[int, int] | None = None,
    tier_split: int = 0,
    heavy_budget: int = 0,
    pairs_budget: int = 0,
    compact_budget: int = 0,
) -> TileBins:
    """Bin every view of a view-stacked projection into one flat pair list:
    gauss_idx indexes the flattened (V*N) gaussians, the tile ranges
    (V, tiles) are offsets into the list, the slot table (V*N, c) holds
    positions in it, and the counts are summed over views. `tile_rows` and
    the caps as in `bin_gaussians`, each view capped on its own."""
    v, n = proj.mean2d.shape[:2]
    idx, starts, ends, tables, culled, dropped = [], [], [], [], [], []
    offset = 0
    for vi in range(v):
        b = bin_gaussians(
            proj.mean2d[vi], proj.depth[vi], proj.radius_tight[vi], width,
            height, pairs_per_gaussian, conic=proj.conic[vi],
            opacity=proj.opacity[vi], rect_candidates=rect_candidates, tile_rows=tile_rows,
            tier_split=tier_split, heavy_budget=heavy_budget, pairs_budget=pairs_budget,
            compact_budget=compact_budget,
        )
        idx.append(b.gauss_idx + vi * n)
        starts.append(b.tile_start + offset)
        ends.append(b.tile_end + offset)
        tables.append(torch.where(b.slot_table >= 0, b.slot_table + offset, b.slot_table))
        culled.append(b.num_culled_pairs)
        dropped.append(b.num_dropped_pairs)
        offset += b.gauss_idx.shape[0]
    count("pairs_binned", offset)
    return TileBins(
        torch.cat(idx).to(torch.int32),
        torch.stack(starts),
        torch.stack(ends),
        torch.stack(culled).sum(),
        torch.cat(tables),
        torch.stack(dropped).sum(),
    )


def _check_caps(backend: str, **caps) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    for name, value in caps.items():
        if value < 0:
            raise ValueError(
                f"{name}={value}: -1 is resolved by the drivers (the auto_* probes), "
                "not by the render"
            )


def _rasterize(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg: torch.Tensor,
    pairs_per_gaussian: int,
    chunk: int,
    max_chunks: int,
    with_objects: bool,
    rect_candidates: int,
    tile_rows: tuple[int, int] | None,
    caps: dict,
) -> dict:
    tiles_x, tiles_y = _tiles(width, height)
    channels = torch.cat([proj.color, proj.obj], dim=-1) if with_objects else proj.color
    n_ch = channels.shape[-1]
    bins = bin_views(proj, width, height, pairs_per_gaussian, rect_candidates, tile_rows,
                     **caps)
    mean2d = proj.mean2d
    if tile_rows is not None:
        tiles_y = tile_rows[1] - tile_rows[0]
        height = tiles_y * TILE
        mean2d = mean2d - mean2d.new_tensor([0.0, float(tile_rows[0] * TILE)])
    img, T = blend_tiles(
        bins.gauss_idx, bins.tile_start, bins.tile_end, mean2d,
        proj.conic, proj.opacity, channels, tiles_x, tiles_y, chunk, max_chunks,
        bins.slot_table,
    )
    img = img[:, :height, :width]
    T = T[:, :height, :width]
    num_truncated = torch.clamp(
        (bins.tile_end - bins.tile_start).to(torch.int64) - chunk * max_chunks, min=0
    ).sum() + bins.num_dropped_pairs
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
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> dict:
    """Multi-view rasterization of a view-stacked projection (leading view
    dimension on every field): each view is binned, and the whole batch
    blends in one launch over a (tiles, views) grid.

    `backend` takes the reference's names for its routes, with their
    rules; the blend itself follows the tensors' device either way.
    "pallas" caps a tile at `max_chunks * CHUNK` pairs and applies
    `pairs_budget`, `compact_budget` and the tiered bin (`tier_split`,
    `heavy_budget`); "xla" caps a tile at `chunk * max_chunks` pairs and,
    as the reference's multi-view XLA route does, applies none of them.

    `tile_rows` = (r0, r1) renders the band of tile rows r0 <= row < r1 of
    the (width, height) image, (r1 - r0) * 16 rows high: binned as the
    whole image's (`bin_gaussians`), blended with the screen means moved
    up by the band's first row (a translation leaves EWA splatting
    unchanged).

    `with_objects=False` blends RGB only and returns `render_object`
    zero-filled. Returns `render` (V, H, W, 3), `render_object`
    (V, H, W, C_obj), `final_transmittance` (V, H, W), and the counts
    `num_culled_pairs` and `num_truncated_pairs` summed over views."""
    caps = dict(tier_split=tier_split, heavy_budget=heavy_budget, pairs_budget=pairs_budget,
                compact_budget=compact_budget)
    _check_caps(backend, **caps)
    if backend == "pallas":
        chunk = CHUNK
    else:
        caps = {}
    return _rasterize(proj, width, height, bg, pairs_per_gaussian, chunk, max_chunks,
                      with_objects, rect_candidates, tile_rows, caps)


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
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> dict:
    """Single-view rasterization on a batch of one, with the reference's
    single-view rules: "pallas" as in `rasterize_views`; "xla" caps a tile
    at `chunk * max_chunks` pairs and applies the tiered bin (the
    reference bins a single view with it on both routes) but not the
    budgets. Returns `render` (H, W, 3), `render_object` (H, W, C_obj),
    `final_transmittance` (H, W), `num_culled_pairs` and
    `num_truncated_pairs`."""
    caps = dict(tier_split=tier_split, heavy_budget=heavy_budget, pairs_budget=pairs_budget,
                compact_budget=compact_budget)
    _check_caps(backend, **caps)
    if backend == "pallas":
        chunk = CHUNK
    else:
        caps = dict(tier_split=tier_split, heavy_budget=heavy_budget)
    out = _rasterize(
        ProjectedGaussians(*(f[None] for f in proj)), width, height, bg,
        pairs_per_gaussian, chunk, max_chunks, with_objects, rect_candidates, None, caps,
    )
    for key in ("render", "render_object", "final_transmittance"):
        out[key] = out[key][0]
    return out
