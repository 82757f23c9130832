"""The reference's steps of the two loops the benchmark times: DAGGER's
PGD iterations (render, detector loss, gradient, an l2 step on the colour
coefficients) and 3DGS training steps (render, (1 - l) L1 + l (1 - SSIM),
gradient, Adam at the 3DGS per-group learning rates), in plain PyTorch on
`render.py` and `frcnn.py`.

Training runs its own three steps from the initial state. DAGGER follows
the judged run step by step (`dagger_judge`): the detector's choices
(proposal ranks, ROI labels at IoU 0.5) flip on rounding-level image
differences, so the reference's detector reads the judged run's images,
and its own render of the same state judges those images.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@torch.no_grad()
def silhouette_bbox(img: torch.Tensor) -> np.ndarray:
    """(H, W, 3) in [0, 1] -> (left, upper, right, lower), right and lower
    exclusive, of the pixels whose byte-rounded ITU-R 601-2 luma is over
    20 (zeros when none is)."""
    rgb = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0)
    luma = torch.div(299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2], 1000,
                     rounding_mode="floor")
    mask = luma > 20
    if not bool(mask.any()):
        return np.zeros(4, np.float32)
    rows = torch.nonzero(mask.any(dim=1))[:, 0]
    cols = torch.nonzero(mask.any(dim=0))[:, 0]
    return np.array([int(cols.min()), int(rows.min()), int(cols.max()) + 1,
                     int(rows.max()) + 1], np.float32)


def l2_step(param, grad, original, alpha: float, epsilon: float):
    """A targeted PGD step of length alpha along -g / ||g|| (one norm over
    the whole tensor), then each splat's change projected onto the epsilon
    ball."""
    gnorm = torch.linalg.vector_norm(grad.reshape(-1))
    new = param - alpha * grad / gnorm if float(gnorm) > 0 else param
    delta = new - original
    rn = torch.linalg.vector_norm(delta.reshape(delta.shape[0], -1), dim=1)
    scale = torch.where(rn > epsilon, epsilon / torch.clamp(rn, min=1e-20), torch.ones_like(rn))
    return original + delta * scale.reshape((-1,) + (1,) * (delta.dim() - 1))


def dagger_setup(scene: dict, cams: list, attack: dict) -> tuple:
    """The attack's pair capacity (the largest tile footprint over the
    views, when the configuration's is -1) and its GT boxes (the
    silhouettes of a benign black-background render), from the initial
    scene."""
    black = torch.zeros(3, device=scene["xyz"].device)
    width, height, deg = cams[0]["width"], cams[0]["height"], attack["sh_degree"]
    with torch.no_grad():
        pairs = attack["pairs_per_gaussian"]
        if pairs < 0:
            pairs = max(R.pairs_per_gaussian(R.project(scene, c, deg), width, height)
                        for c in cams)
        cap = attack["chunk"] * attack["max_chunks"]
        boxes = np.stack([silhouette_bbox(R.render_views(scene, [c], black, pairs, cap,
                                                         deg)["render"][0]) for c in cams])
    return pairs, boxes


def dagger_step(scene: dict, params: dict, originals: dict, cams: list, detector, attack: dict,
                pairs: int, boxes, detect_on=None):
    """One PGD iteration from `params`: the batch rendered, the detector's
    loss on it (or on `detect_on`, images judged in its place), the
    gradient of every leaf through the render, an l2 step on the colour
    coefficients. Returns (images, loss, gradients, new params)."""
    black = torch.zeros(3, device=scene["xyz"].device)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img = R.render_views({**scene, **leaves}, cams, black, pairs,
                         attack["chunk"] * attack["max_chunks"], attack["sh_degree"])["render"]
    x = (img if detect_on is None else detect_on).detach().requires_grad_(True)
    loss = detector.loss(x, attack["target"], boxes)
    (g_img,) = torch.autograd.grad(loss, [x])
    grads = dict(zip(leaves, torch.autograd.grad(img, list(leaves.values()), grad_outputs=g_img,
                                                 allow_unused=True)))
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
    with torch.no_grad():
        new = dict(params)
        for k in ("f_dc", "f_rest"):
            new[k] = l2_step(params[k], grads[k], originals[k], attack["alpha"], attack["epsilon"])
    return img.detach(), float(loss.detach()), grads, new


def dagger_run(scene: dict, cams: list, detector, attack: dict, steps: int) -> dict:
    """The reference's own attack for `steps` iterations from `scene`:
    what a program run records (losses, loss-render images, the first
    step's gradients, the parameters before and after every step)."""
    pairs, boxes = dagger_setup(scene, cams, attack)
    params = {k: scene[k].detach().clone() for k in R.PARAM_NAMES}
    rec = {"losses": [], "images": [], "grads": None, "states": [params]}
    for _ in range(steps):
        img, loss, grads, params = dagger_step(scene, params, rec["states"][0], cams, detector,
                                               attack, pairs, boxes)
        rec["losses"].append(loss)
        rec["images"].append(img)
        rec["grads"] = rec["grads"] or grads
        rec["states"].append(params)
    return rec


def dagger_judge(rec: dict, scene: dict, cams: list, detector, attack: dict) -> dict:
    """The reference's step k from the judged run's state before it (its
    own initial scene for the first): its render of that state, its
    detector's loss on the judged run's images of step k, the gradients
    through its own render, and its l2 step."""
    pairs, boxes = dagger_setup(scene, cams, attack)
    originals = {k: scene[k].detach().clone() for k in R.PARAM_NAMES}
    dev = scene["xyz"].device
    out = {"images": [], "losses": [], "grads": None, "states": []}
    for k, judged in enumerate(rec["images"]):
        state = originals if k == 0 else {n: v.to(dev) for n, v in rec["states"][k].items()}
        img, loss, grads, new = dagger_step(scene, state, originals, cams, detector, attack,
                                            pairs, boxes, detect_on=judged.to(dev))
        out["images"].append(img.cpu())
        out["losses"].append(loss)
        out["grads"] = out["grads"] or {n: g.cpu() for n, g in grads.items()}
        out["states"].append({n: v.cpu() for n, v in new.items()})
    return out


def _gauss_window(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size)
    g = np.exp(-((xs - size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, size: int = 11, sigma: float = 1.5):
    """Mean SSIM of two (H, W, C) images, gaussian window, zero padding."""
    x1, x2 = img1.permute(2, 0, 1)[None], img2.permute(2, 0, 1)[None]
    c = x1.shape[1]
    g = torch.as_tensor(_gauss_window(size, sigma), device=x1.device)
    kern = (g[:, None] * g[None, :]).expand(c, 1, size, size).contiguous()

    def filt(x):
        return F.conv2d(x, kern, padding=size // 2, groups=c)

    mu1, mu2 = filt(x1), filt(x2)
    s1 = filt(x1 * x1) - mu1 * mu1
    s2 = filt(x2 * x2) - mu2 * mu2
    s12 = filt(x1 * x2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def train_loss(pred, gt, lambda_dssim: float):
    return (1.0 - lambda_dssim) * (pred - gt).abs().mean() + lambda_dssim * (1.0 - ssim(pred, gt))


def position_lr(step: int, init: float, final: float, delay_mult: float, max_steps: int) -> float:
    """3DGS's log-linear position learning rate (no delay steps)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def learning_rates(train: dict, extent: float, step: int) -> dict:
    return {
        "xyz": position_lr(step, train["position_lr_init"] * extent,
                           train["position_lr_final"] * extent,
                           train["position_lr_delay_mult"], train["position_lr_max_steps"]),
        "f_dc": train["feature_lr"], "f_rest": train["feature_lr"] / 20.0,
        "opacity_logit": train["opacity_lr"], "log_scale": train["scaling_lr"],
        "quat": train["rotation_lr"], "obj_dc": train["feature_lr"],
    }


STAT_NAMES = ("xyz_gradient_accum", "denom", "max_radii2d")


def train_steps(scene: dict, cams: list, gts: list, train: dict, extent: float, seed: int,
                steps: int) -> dict:
    """`steps` 3DGS training steps from `scene` (already at the trainer's
    capacity, with Adam's moments at zero): each on a view drawn by
    `torch.randint` from a CPU generator seeded by `seed`, the 19-channel
    render, the loss on its RGB, and Adam (b1 0.9, b2 0.999, eps 1e-15).
    The densify statistics accumulate as 3DGS's do: per visible splat
    (radius > 0), the norm of the loss's gradient with respect to its
    screen mean (in pixels), a count of the steps it was visible, and its
    largest radius."""
    dev = scene["xyz"].device
    black = torch.zeros(3, device=dev)
    views = torch.Generator().manual_seed(seed)
    tile_cap = train["chunk"] * train["max_chunks"]
    params = {k: scene[k].detach().clone() for k in R.PARAM_NAMES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    n = params["xyz"].shape[0]
    stats = {k: torch.zeros(n, device=dev) for k in STAT_NAMES}
    losses, first_grads, order = [], None, []
    for step in range(steps):
        vi = int(torch.randint(0, len(cams), (1,), generator=views))
        order.append(vi)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        offset = torch.zeros((n, 2), device=dev, requires_grad=True)
        out = R.render_views({**scene, **leaves}, [cams[vi]], black,
                             train["pairs_per_gaussian"], tile_cap, train["sh_degree"],
                             mean2d_offset=offset)
        loss = train_loss(out["render"][0], gts[vi], train["lambda_dssim"])
        got = torch.autograd.grad(loss, [*leaves.values(), offset], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, got)}
        if first_grads is None:
            first_grads = grads
        lrs = learning_rates(train, extent, step)
        bc1, bc2 = 1 - ADAM_B1 ** (step + 1), 1 - ADAM_B2 ** (step + 1)
        with torch.no_grad():
            for k in params:
                g = grads[k]
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * nu[k]
                params[k] = params[k] - lrs[k] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                                  + ADAM_EPS)
            radius = out["projs"][0]["radius"].to(torch.float32)
            seen = radius > 0
            g2 = got[-1].detach().float()
            stats["xyz_gradient_accum"] += torch.where(seen, torch.sqrt((g2 * g2).sum(-1)), 0.0)
            stats["denom"] += seen.to(torch.float32)
            stats["max_radii2d"] = torch.maximum(stats["max_radii2d"], radius)
        losses.append(float(loss))
    return {"losses": losses, "grads": first_grads, "params": params, "order": order,
            "stats": stats}


N_SPLIT = 2


@torch.no_grad()
def densify(before: dict, train: dict, extent: float, noise: torch.Tensor,
            screen_limit: bool) -> dict:
    """3DGS's clone, split and prune over a fixed capacity of slots, from
    `before` (`params` and Adam's `mu` and `nu` by name, `alive`, the
    `stats` by `STAT_NAMES`), as the program's trainer states them:

    * a live splat is hot when its accumulated screen gradient over its
      visible steps is at least the threshold; a hot splat whose largest
      scale is at most `percent_dense * extent` is cloned (a copy), a
      larger one split into two children at N(0, scale) rotated into the
      world (`noise` (2, C, 3) holds the draws) with scale / 1.6, and the
      parent pruned;
    * a live splat is pruned when its opacity is under `min_opacity`, and,
      with the screen limit, when its largest screen radius is over
      `max_screen_size` or its largest scale over 0.1 * extent (judged on
      the parents);
    * the children take the slots the survivors leave free: clones in
      their parents' slot order, then each split's first child, then each
      second child; those past the last free slot are dropped, and the
      capacity then grows to int(capacity * capacity_headroom);
    * survivors keep their Adam moments; children start from zero.

    Returns the live splats after (`params`, `mu`, `nu`, in no particular
    order), their `count` and the `capacity`."""
    p, alive, st = before["params"], before["alive"], before["stats"]
    capacity = alive.shape[0]
    hot_grad = torch.nan_to_num(st["xyz_gradient_accum"] / torch.clamp(st["denom"], min=1.0))
    scale = torch.exp(p["log_scale"])
    largest = scale.max(dim=-1).values
    hot = (hot_grad >= train["densify_grad_threshold"]) & alive
    clone = hot & (largest <= train["percent_dense"] * extent)
    split = hot & (largest > train["percent_dense"] * extent)
    prune = torch.sigmoid(p["opacity_logit"][:, 0]) < train["min_opacity"]
    if screen_limit:
        prune = prune | (st["max_radii2d"] > train["max_screen_size"]) \
            | (largest > 0.1 * extent)
    keep = alive & ~(prune | split)
    free = capacity - int(keep.sum())

    rows = R.rotation(p["quat"][split])
    waves = [{k: v[clone] for k, v in p.items()}]
    for i in range(N_SPLIT):
        d = noise[i][split] * scale[split]
        offset = torch.stack([rows[r][0] * d[:, 0] + rows[r][1] * d[:, 1] + rows[r][2] * d[:, 2]
                              for r in range(3)], dim=-1)
        waves.append({**{k: v[split] for k, v in p.items()},
                      "xyz": p["xyz"][split] + offset,
                      "log_scale": torch.log(scale[split] / (0.8 * N_SPLIT))})
    placed, dropped = [], 0
    for wave in waves:
        n = wave["xyz"].shape[0]
        take = min(n, free)
        placed.append({k: v[:take] for k, v in wave.items()})
        free -= take
        dropped += n - take
    out = {"params": {k: torch.cat([p[k][keep]] + [w[k] for w in placed]) for k in p}}
    for m in ("mu", "nu"):
        out[m] = {k: torch.cat([before[m][k][keep]]
                               + [torch.zeros_like(w[k]) for w in placed]) for k in p}
    out["count"] = int(keep.sum()) + sum(int(w["xyz"].shape[0]) for w in placed)
    out["capacity"] = int(capacity * train["capacity_headroom"]) if dropped else capacity
    out["made"] = {"clone": int(clone.sum()), "split": int(split.sum()),
                   "pruned": int((alive & ~keep).sum()), "dropped": dropped}
    return out


@torch.no_grad()
def reset_opacity(before: dict) -> dict:
    """3DGS's opacity reset: every opacity capped at 0.01 (as a logit), the
    opacity's Adam moments zeroed, nothing else changed. Returns the live
    splats after, as `densify` does."""
    p, alive = before["params"], before["alive"]
    op = torch.clamp(torch.sigmoid(p["opacity_logit"]), max=0.01)
    params = {**p, "opacity_logit": torch.log(op / (1.0 - op))}
    out = {"params": {k: v[alive] for k, v in params.items()}}
    for m in ("mu", "nu"):
        out[m] = {k: (torch.zeros_like(v) if k == "opacity_logit" else v)[alive]
                  for k, v in before[m].items()}
    out["count"], out["capacity"] = int(alive.sum()), alive.shape[0]
    return out
