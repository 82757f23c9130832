"""The plain reference renderer: projection, tile binning and the
front-to-back blend of 3D Gaussian splats, in plain PyTorch with autograd.

A frozen copy of the semantics the program implements (the Inria
rasterizer's preprocess, 16x16 tiles, the exact ellipse test per tile, one
depth sort per view, alpha capped at 0.99 and skipped below 1/255, a pixel
stopping before its transmittance would fall under 1e-4, at most
`tile_cap` pairs a tile), written for this benchmark. It imports nothing of
the program: a scene is a dict of tensors, a camera a dict made by
`camera.make_camera`.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
PARAM_NAMES = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit", "obj_dc")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def rgb_to_sh(rgb):
    return (rgb - 0.5) / SH_C0


def sh_color(deg: int, feats: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH up to degree 3 of coefficient-major (N, K, 3) features at
    unit directions (N, 3), before the +0.5 shift."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    basis = [SH_C0 * torch.ones_like(x)]
    if deg > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if deg > 2:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    out = basis[0] * feats[:, 0, :]
    for k in range(1, len(basis)):
        out = out + basis[k] * feats[:, k, :]
    return out


def rotation(quat: torch.Tensor) -> list:
    """Rows of the rotation matrix of the normalised wxyz quaternion, each
    entry an (N,) tensor."""
    q = quat * torch.rsqrt(torch.sum(quat * quat, dim=-1, keepdim=True) + 1e-24)
    r, x, y, z = q.unbind(-1)
    return [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
            [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
            [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]


def covariance6(log_scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Packed (xx, xy, xz, yy, yz, zz) of R diag(s^2) R^T, s = exp(log_scale),
    R from the normalised wxyz quaternion."""
    R = rotation(quat)
    s2 = torch.square(torch.exp(log_scale))

    def cov(i, j):
        return s2[:, 0] * R[i][0] * R[j][0] + s2[:, 1] * R[i][1] * R[j][1] \
            + s2[:, 2] * R[i][2] * R[j][2]

    return torch.stack([cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), cov(2, 2)], -1)


def _affine(xyz, m, rows):
    return torch.stack([xyz[:, 0] * m[i, 0] + xyz[:, 1] * m[i, 1] + xyz[:, 2] * m[i, 2] + m[i, 3]
                        for i in rows], dim=-1)


def project(scene: dict, cam: dict, sh_degree: int) -> dict:
    """Screen-space quantities of every splat for one camera: mean2d (N, 2)
    pixels, depth (N,), conic (N, 3), radius (N,) int32 (0 = culled), the
    opacity-aware binning radius `radius_tight` (N,), opacity (N,) and the
    19 blended channels (N, 19): RGB from SH, then the 16 object
    features."""
    xyz, view, full = scene["xyz"], cam["view"], cam["full_proj"]
    w_, h_ = cam["width"], cam["height"]
    depth = _affine(xyz, view, [2])[:, 0]
    in_front = depth > 0.2
    hom = _affine(xyz, full, [0, 1, 2])
    w = _affine(xyz, full, [3])[:, 0]
    w = torch.where(in_front, w, torch.ones_like(w))
    ndc = hom * (1.0 / (w + 1e-7))[:, None]
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * w_ - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * h_ - 1.0) * 0.5], dim=-1)

    c6 = covariance6(scene["log_scale"], scene["quat"])
    t = _affine(xyz, view, [0, 1, 2])
    tz = torch.where(t[:, 2] > 0.2, t[:, 2], torch.ones_like(t[:, 2]))
    tanx, tany = cam["tanfovx"], cam["tanfovy"]
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -1.3 * tanx), 1.3 * tanx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -1.3 * tany), 1.3 * tany) * tz
    fx, fy = w_ / (2.0 * tanx), h_ / (2.0 * tany)
    W = view[:3, :3]
    m0 = (fx / tz)[:, None] * W[0][None] + (-fx * tx / (tz * tz))[:, None] * W[2][None]
    m1 = (fy / tz)[:, None] * W[1][None] + (-fy * ty / (tz * tz))[:, None] * W[2][None]
    xx, xy, xz, yy, yz, zz = c6.unbind(-1)

    def quad(a, b):
        return (xx * a[:, 0] * b[:, 0] + yy * a[:, 1] * b[:, 1] + zz * a[:, 2] * b[:, 2]
                + xy * (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0])
                + xz * (a[:, 0] * b[:, 2] + a[:, 2] * b[:, 0])
                + yz * (a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1]))

    a, b, c = quad(m0, m0) + 0.3, quad(m0, m1), quad(m1, m1) + 0.3
    det = a * c - b * b
    ok = det != 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.maximum(mid * mid - det, torch.full_like(det, 0.1)))
    lam0 = torch.maximum(lam, torch.zeros_like(lam))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam0))
    alive = scene["alive"]
    visible = in_front & ok & alive
    zero = torch.zeros_like(radius_f)
    opacity = torch.sigmoid(scene["opacity_logit"][:, 0]) * alive
    q_cut = 2.0 * torch.log(torch.clamp(opacity * 255.0, min=1e-6))
    r_tight = torch.sqrt(torch.maximum(q_cut, zero) * lam0)

    dirs = xyz - cam["cam_center"][None]
    n2 = torch.sum(dirs * dirs, dim=-1, keepdim=True)
    safe = n2 > 1e-18
    dirs = torch.where(safe, dirs / torch.sqrt(torch.where(safe, n2, torch.ones_like(n2))),
                       torch.zeros_like(dirs))
    feats = torch.cat([scene["f_dc"], scene["f_rest"]], dim=1)
    color = torch.relu(sh_color(sh_degree, feats, dirs) + 0.5)
    obj = torch.relu(scene["obj_dc"][:, 0, :] * SH_C0 + 0.5)
    return {
        "mean2d": mean2d, "depth": depth, "conic": conic,
        "radius": torch.where(visible, radius_f, zero).to(torch.int32),
        "radius_tight": torch.where(visible, torch.minimum(radius_f, r_tight + 0.01), zero),
        "opacity": opacity, "channels": torch.cat([color, obj], dim=-1),
    }


def _tiles(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def _tile_rect(mean2d, radius, tiles_x, tiles_y):
    r = radius.to(torch.float32)

    def bound(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    return (bound(torch.floor((mean2d[:, 0] - r) / TILE), tiles_x),
            bound(torch.floor((mean2d[:, 0] + r) / TILE) + 1, tiles_x),
            bound(torch.floor((mean2d[:, 1] - r) / TILE), tiles_y),
            bound(torch.floor((mean2d[:, 1] + r) / TILE) + 1, tiles_y))


@torch.no_grad()
def pairs_per_gaussian(proj: dict, width: int, height: int) -> int:
    """The largest tile footprint of any splat by its binning radius,
    rounded up to 4 (at least 4): a per-splat pair capacity that keeps
    every candidate tile."""
    rx0, rx1, ry0, ry1 = _tile_rect(proj["mean2d"], proj["radius_tight"], *_tiles(width, height))
    area = torch.where(proj["radius_tight"] > 0, (rx1 - rx0) * (ry1 - ry0), 0)
    m = max(int(area.max()) if area.numel() else 0, 4)
    return -(-m // 4) * 4


def _box_quad_min(a, b, c, lx, ux, ly, uy):
    """Least value of a dx^2 + 2b dx dy + c dy^2 over the box."""
    inside = (lx <= 0.0) & (ux >= 0.0) & (ly <= 0.0) & (uy >= 0.0)
    cs, as_ = torch.clamp(c, min=1e-12), torch.clamp(a, min=1e-12)

    def q(x, y):
        return a * x * x + 2.0 * b * x * y + c * y * y

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    qe = torch.minimum(
        torch.minimum(q(lx, clip(-b * lx / cs, ly, uy)), q(ux, clip(-b * ux / cs, ly, uy))),
        torch.minimum(q(clip(-b * ly / as_, lx, ux), ly), q(clip(-b * uy / as_, lx, ux), uy)))
    return torch.where(inside, torch.zeros_like(qe), qe)


@torch.no_grad()
def bin_view(proj: dict, width: int, height: int, per_gaussian: int):
    """(gauss_idx (P,) int64, tile_start (T,), tile_end (T,)): each splat's
    first `per_gaussian` cells of its tile rect, row-major, that can see
    alpha >= 1/255, sorted by (tile, depth) on one packed key; equal keys
    keep splat order."""
    mean2d, conic, opacity = proj["mean2d"], proj["conic"], proj["opacity"]
    n, dev = mean2d.shape[0], mean2d.device
    tiles_x, tiles_y = _tiles(width, height)
    num_tiles = tiles_x * tiles_y
    rx0, rx1, ry0, ry1 = _tile_rect(mean2d, proj["radius_tight"], tiles_x, tiles_y)
    rect_w = rx1 - rx0
    touched = torch.where(proj["radius_tight"] > 0, rect_w * (ry1 - ry0), 0)
    j = torch.arange(per_gaussian, dtype=torch.int32, device=dev)[None]
    w_safe = torch.clamp(rect_w, min=1)[:, None]
    tx = rx0[:, None] + j % w_safe
    ty = ry0[:, None] + torch.div(j, w_safe, rounding_mode="floor")
    lx = (tx * TILE).to(torch.float32) - mean2d[:, 0:1]
    ly = (ty * TILE).to(torch.float32) - mean2d[:, 1:2]
    qmin = _box_quad_min(conic[:, 0:1], conic[:, 1:2], conic[:, 2:3],
                         lx, lx + (TILE - 1.0), ly, ly + (TILE - 1.0))
    q_cut = (2.0 * torch.log(torch.clamp(opacity * 255.0, min=1e-6)) + 1e-3)[:, None]
    pd = (conic[:, 0:1] > 0.0) & (conic[:, 2:3] > 0.0)
    valid = (j < touched[:, None]) & ((qmin <= q_cut) | ~pd)
    tile_id = ty * tiles_x + tx
    depth_bits = 32 - max(int(math.ceil(math.log2(num_tiles + 2))), 1)
    d = proj["depth"]
    dq = torch.clamp((torch.clamp(d / (d + 1.0), 0.0, 1.0 - 1e-7) * float(2.0 ** depth_bits))
                     .to(torch.int64), max=2 ** depth_bits - 1)
    key = (tile_id.to(torch.int64) << depth_bits) | dq[:, None]
    gidx = torch.arange(n, device=dev)[:, None].expand(n, per_gaussian)
    key, gidx = key[valid], gidx[valid]
    skey, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        skey, torch.arange(num_tiles + 1, device=dev, dtype=torch.int64) << depth_bits)
    return gidx[order], bounds[:-1], bounds[1:]


def bin_views(projs: list, width: int, height: int, per_gaussian: int):
    """Every view's bins as one pair list over the flattened (V * N)
    splats: (gauss_idx (P,), tile_start (V, T), tile_end (V, T))."""
    n = projs[0]["mean2d"].shape[0]
    idx, starts, ends, offset = [], [], [], 0
    for vi, p in enumerate(projs):
        g, s, e = bin_view(p, width, height, per_gaussian)
        idx.append(g + vi * n)
        starts.append(s + offset)
        ends.append(e + offset)
        offset += g.shape[0]
    return torch.cat(idx), torch.stack(starts), torch.stack(ends)


def blend(gauss_idx, tile_start, tile_end, rows, tiles_x: int, tiles_y: int,
          tile_cap: int, chunk: int = 32):
    """Front-to-back blend of every tile of every view: `rows` (V * N,
    6 + CH) hold mean2d 2, conic 3, opacity 1 and the channels. Returns
    image (V, H_pad, W_pad, CH), final transmittance (V, H_pad, W_pad) and
    `last` (V, H_pad, W_pad), the count of a pixel's pairs up to its last
    composited one. Each tile blends at most `tile_cap` pairs; the chunks
    are recomputed in the backward (only their carries are kept)."""
    v = tile_start.shape[0]
    n_ch = rows.shape[1] - 6
    dev = rows.device
    pair_rows = rows[gauss_idx]
    start = tile_start.reshape(-1)
    count = (tile_end.reshape(-1) - start).clamp(0, tile_cap)
    m = start.shape[0]
    p = TILE * TILE
    tid = torch.arange(tiles_x * tiles_y, device=dev).repeat(v)
    pix = torch.arange(p, device=dev)
    pxf = ((tid % tiles_x)[:, None] * TILE + pix % TILE).to(torch.float32)[:, None, :]
    pyf = ((tid // tiles_x)[:, None] * TILE + pix // TILE).to(torch.float32)[:, None, :]
    lane = torch.arange(chunk, device=dev)
    top = max(pair_rows.shape[0] - 1, 0)

    def step(k0, accum, T, done, last, pair_rows):
        j = k0 + lane
        idx = (start[:, None] + j).clamp(max=top)
        valid = (j[None] < count[:, None])[..., None]
        g = pair_rows[idx]
        dx, dy = pxf - g[..., 0:1], pyf - g[..., 1:2]
        power = -0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) - g[..., 3:4] * dx * dy
        alpha = torch.minimum(g[..., 5:6] * torch.exp(torch.clamp(power, max=0.0)),
                              power.new_tensor(ALPHA_MAX))
        use = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        # Transmittance after each pair, by a running product in pair order.
        t_after = T[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        stop = (t_after < T_EPS) & use
        # A pixel takes the pairs before the first one that would stop it.
        stopped_before = (torch.cumsum(stop.to(torch.int32), dim=1) - stop.to(torch.int32)) > 0
        take = use & ~stopped_before & ~stop & ~done[:, None, :]
        a_eff = torch.where(take, alpha, torch.zeros_like(alpha))
        t_incl = T[:, None, :] * torch.cumprod(1.0 - a_eff, dim=1)
        t_before = torch.cat([T[:, None, :], t_incl[:, :-1]], dim=1)
        accum = accum + torch.einsum("mkp,mkc->mpc", a_eff * t_before, g[..., 6:])
        hit = torch.where(take, j[None, :, None] + 1, 0).amax(dim=1)
        return (accum, t_incl[:, -1], done | stop.any(dim=1),
                torch.maximum(last, hit))

    accum = torch.zeros((m, p, n_ch), dtype=torch.float32, device=dev)
    T = torch.ones((m, p), dtype=torch.float32, device=dev)
    done = torch.zeros((m, p), dtype=torch.bool, device=dev)
    last = torch.zeros((m, p), dtype=torch.int64, device=dev)
    top_count = int(count.max()) if m else 0
    for k0 in range(0, top_count, chunk):
        if torch.is_grad_enabled() and pair_rows.requires_grad:
            accum, T, done, last = checkpoint(step, k0, accum, T, done, last, pair_rows,
                                              use_reentrant=False)
        else:
            accum, T, done, last = step(k0, accum, T, done, last, pair_rows)

    def image(x):
        x = x.reshape(v, tiles_y, tiles_x, TILE, TILE, *x.shape[2:])
        x = x.permute(0, 1, 3, 2, 4, *range(5, x.dim()))
        return x.reshape(v, tiles_y * TILE, tiles_x * TILE, *x.shape[5:])

    return image(accum), image(T), image(last)


def render_views(scene: dict, cams: list, bg: torch.Tensor, per_gaussian: int, tile_cap: int,
                 sh_degree: int, chunk: int = 32, mean2d_offset=None) -> dict:
    """The (V, H, W, 3) RGB of `cams` (same size) over background `bg`,
    blended at 19 channels as the program blends them, with the bins and
    the blend's inputs for counting its work. `mean2d_offset`, when given,
    is added to every view's screen means."""
    width, height = cams[0]["width"], cams[0]["height"]
    tiles_x, tiles_y = _tiles(width, height)
    projs = [project(scene, c, sh_degree) for c in cams]
    if mean2d_offset is not None:
        projs = [{**p, "mean2d": p["mean2d"] + mean2d_offset} for p in projs]
    idx, start, end = bin_views(projs, width, height, per_gaussian)
    rows = torch.cat([torch.cat([p["mean2d"], p["conic"], p["opacity"][:, None],
                                 p["channels"]], dim=-1) for p in projs])
    img, T, last = blend(idx, start, end, rows, tiles_x, tiles_y, tile_cap, chunk)
    img, T = img[:, :height, :width], T[:, :height, :width]
    n_ch = img.shape[-1]
    out = img + T[..., None] * torch.cat([bg, bg.new_zeros(n_ch - bg.shape[0])])
    return {"render": out[..., :3], "projs": projs, "bins": (idx, start, end),
            "last": last, "rows": rows, "tiles": (tiles_x, tiles_y)}
