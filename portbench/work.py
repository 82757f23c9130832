"""The yardstick's arithmetic: the H100's published peaks, the least time
the blend's work needs on them, and the FLOPs of a PGD iteration.

The blend's counts are a frozen copy of the repository's chip smoke test
(`bound`, `pair_work`, the OPS_* constants and its byte counts), so that a
blend kernel is held to the same work whatever implements it. The work is
counted from the reference's own binning and forward of the cell's scene
and views, never from the program's.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores (the program runs with TF32 off). The
# blend's exp goes to the SFUs, counted as one fp32 operation.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# fp32 operations per (pixel, pair), an FMA counted as two and the exp as
# one. Every evaluated pair pays the alpha test: power 11, alpha 4, the two
# skip tests 2. A live (composited) pair adds, in the forward, the
# transmittance test 3, the weight 1 and 2 per channel; in the backward,
# the T recovery 2, the weight 1, dalpha 3, the suffix 2, the clamp 2, the
# five geometry gradients 17, the opacity 1, 3 per channel, and its share of
# the sum over the tile's pixels, one add for each of its 6 + CH values. A
# pixel's stopping pair adds the forward's transmittance test.
OPS_ALPHA = 17
OPS_FWD_STOP = 3


def ops_fwd_live(ch: int) -> int:
    return 4 + 2 * ch


def ops_bwd_live(ch: int) -> int:
    return 34 + 4 * ch


def bound(nbytes: float, ops: float) -> float:
    """The least seconds for `nbytes` moved and `ops` fp32 operations at
    the peak rates: the larger of the two."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)


def pair_work(idx, blend_in, tiles, cap: int, last, chunk: int = 32) -> dict:
    """The (pixel, pair) work the blend does on these inputs, from the
    forward's `last` (each pixel's count of pairs up to its last composited
    one): `fwd_eval` pairs whose alpha the forward computes (a pixel's pairs
    up to the one that stops it, else its tile's whole capped range),
    `stops` the pixels stopped, `bwd_eval` the pairs the backward computes
    (those below the pixel's `last`), `live` the composited pairs among
    them."""
    import torch

    gauss_idx, tile_start, tile_end = idx
    mean2d, conic, opacity, colors = (x.detach() for x in blend_in)
    tiles_x, tiles_y = tiles
    v, n, _ = colors.shape
    dev = colors.device
    geom = torch.cat([mean2d, conic, opacity[..., None]], -1).reshape(v * n, 6)
    start = tile_start.reshape(-1).long()
    count = (tile_end.reshape(-1).long() - start).clamp(0, cap)
    m = start.shape[0]
    tid = torch.arange(tiles_x * tiles_y, device=dev).repeat(v)
    pix = torch.arange(256, device=dev)
    px = ((tid % tiles_x)[:, None] * 16 + pix % 16).float()[:, None, :]
    py = ((tid // tiles_x)[:, None] * 16 + pix // 16).float()[:, None, :]
    last_t = (last.reshape(v, tiles_y, 16, tiles_x, 16).permute(0, 1, 3, 2, 4)
              .reshape(m, 1, 256).long())
    stop = torch.full((m, 256), cap, dtype=torch.long, device=dev)
    live = 0
    for k0 in range(0, int(count.max()), chunk):
        j = torch.arange(k0, k0 + chunk, device=dev)
        valid = (j[None, :] < count[:, None])[..., None]
        g = geom[gauss_idx[(start[:, None] + j).clamp(max=gauss_idx.shape[0] - 1)].long()]
        dx, dy = px - g[..., 0:1], py - g[..., 1:2]
        power = -0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) - g[..., 3:4] * dx * dy
        alpha_pre = g[..., 5:6] * torch.exp(power.clamp(max=0.0))
        use = (power <= 0.0) & (alpha_pre.clamp(max=0.99) >= 1.0 / 255.0) & valid
        below = j[None, :, None] < last_t
        live += int((use & below).sum())
        j_past = torch.where(use & ~below, j[None, :, None], cap)
        stop = torch.minimum(stop, j_past.amin(dim=1))
    stopped = stop < cap
    return {"fwd_eval": int(torch.where(stopped, stop + 1, count[:, None]).sum()),
            "stops": int(stopped.sum()), "bwd_eval": int(last.long().sum()), "live": live}


def blend_bounds(n_pairs: int, v: int, n: int, ch: int, tiles: int, pixels: int,
                 table_cols: int, work: dict) -> dict:
    """The least seconds of the forward kernel, of the backward kernel and
    of the backward's per-splat sum, each input read once and each output
    written once: the pair list and the tile ranges, the splats' 6 + CH
    values, the image and its T and `last` (the backward reads T, `last`
    and the image's gradient); the backward writes one row of 6 + CH per
    pair, which the sum reads back with the (V * N, c) slot table."""
    ranges = 2 * v * tiles * 4
    per_gauss = v * n * (6 + ch) * 4
    rows = n_pairs * (6 + ch) * 4
    fwd_bytes = 4 * n_pairs + ranges + per_gauss + pixels * (ch + 2) * 4
    bwd_bytes = 4 * n_pairs + ranges + per_gauss + pixels * (ch + 3) * 4 + rows
    sum_b = (v * n * table_cols + (n_pairs + v * n) * (6 + ch)) * 4
    fwd_ops = (work["fwd_eval"] * OPS_ALPHA + work["live"] * ops_fwd_live(ch)
               + work["stops"] * OPS_FWD_STOP)
    bwd_ops = work["bwd_eval"] * OPS_ALPHA + work["live"] * ops_bwd_live(ch)
    sum_ops = n_pairs * (6 + ch)
    return {"fwd": bound(fwd_bytes, fwd_ops), "bwd": bound(bwd_bytes, bwd_ops),
            "sum": bound(sum_b, sum_ops), "fwd_ops": fwd_ops, "bwd_ops": bwd_ops,
            "sum_ops": sum_ops}


def flops_of(fn) -> int:
    """The FLOPs `torch.utils.flop_counter` counts in `fn()` (matrix
    products and convolutions, 2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
