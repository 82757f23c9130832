#!/usr/bin/env python3
"""Smoke run of `gsattack_torch` on one CUDA card: builds the kernels from
`gsattack_torch/csrc` (the tile blend, the backward's per-gaussian sum and
the row gather), holds them against their plain PyTorch version, drives
the DAGGER attack end to end and twice (bit for bit the same),
drives the row gather's micro-bench, runs the detector zoo at full width,
with DAGGER against each main detector, trains a 3DGS scene and CLOAKs
it at full width, drives the command line (train, attack, render-eval,
asr, coco-ap, recolor, combine, grouping-render) through files, runs the
attack and the trainer over a (views, splats) device mesh of processes on
the card, drives the profiler and the viewer, and the static caps of the
reference's Pallas route.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. Device: the card's name and power limit (nvidia-smi), the kernel build
     and its time, with ptxas's register / shared-memory report.
  2. Kernel vs plain on a seeded 10k-splat SH3 scene, a fifth of it nearly
     opaque so that the 0.99 alpha cap clips some live pairs (their count
     must be above 0), 256x256, 2 views, 19 channels, no truncated pairs:
     image and T max abs error (gate 1e-5) and the max relative error of
     every blend gradient and of every scene-parameter gradient through
     `project` (gate 1e-3).
  2b. Kernel vs plain (the same 2048-pair cap, same gates) at 3 and 19
     channels on one view of tiles built directly (`edge_tile_inputs`):
     tiles of 0, 1, B - 1, B and B + 1 pairs for each staging batch B of
     the kernels, and of 2047, 2048 and 2049 pairs, with splats at opacity
     0.999 centred on pixels; each tile's deepest last contributor must be
     its capped pair count, so the backward starts at every batch edge.
  3. Kernel vs plain at the main path's shapes (100k splats, SH3, 800x800,
     4 views, 19 channels), the backward as autograd runs it (`blend_bwd`'s
     per-pair rows summed by `gather_sum_rows` over the slot table), with
     each kernel's time, the plain version's time and the least time the
     card could take (its bound), from the (pixel, pair) work these inputs
     need; `gather_sum_rows` equal to its plain version (`torch.equal`) and
     timed beside `index_add_`, and on its edge cases (`gather_sum_edges`),
     the two backward kernels timed apart and
     together beside the fused atomic kernel's 0.8637 ms they replace; and
     the backward's (warp, pair) steps with a live lane, with the warp
     shuffles that summing their gradients takes by a butterfly per value
     and by the reduce-scatter.
  4. Main path: `run_dagger` with the toy head on that scene, yaw-augmented
     to 4 views, chunk 128 x max_chunks 16 (a 2048-pair tile cap), cuDNN's
     deterministic algorithms on (`deterministic_cudnn`), with the
     launch counters set to 0 just before and read just after (each blend
     kernel and `gather_sum_rows` launched), and its
     PGD it/s from the times of its per-iteration log lines; then fwd+bwd
     Mpix/s (RGB and with the object channels), timed with CUDA events
     after a warm-up; then where the time of a loss-and-step iteration
     (run_dagger's loop without its eval render) goes: device time by
     kernel and the busy share (torch.profiler), and the host wall time
     of each stage.
  4b. Reproducibility: the backward three times on phase 3's inputs, equal
     (`torch.equal`); one loss-and-gradient of phase 4's attack twice,
     stage by stage, with cuDNN's default algorithms and its deterministic
     ones (which stage varies: the toy head's image gradient with the
     defaults); phase 4's `run_dagger` again, its losses and its f_dc
     after all its PGD iterations equal to phase 4's.
  5. Row gather (`ops/gather.py`): (a) edge cases, each equal to the plain
     version (`torch.equal`) with one launch (none for M = 0): W = 3 and a
     misaligned W = 4 source (the scalar path), W = 40, S = 1, repeated
     indices, M = 1 and M = 0; (b) at S = 1,787,904 source rows, M =
     2,217,984 indices and W of 16, 32 and 40, the kernel equal to the
     plain version and to `torch.index_select`, with the kernel's, the
     plain version's and `index_select`'s times and the byte bound; (c)
     `python -m gsattack_torch.scripts.micro_gather` (`main`, one launch
     setting, 4 timed calls) in this process, which must return 0, with
     the gather's launch count set to 0 just before and read just after.
  6. Detectors (`models/`) at full width on phase 4's 4 views (800x800),
     weights from seed 0: yolov8 (n, imgsz 640, 80 classes), detectron2
     (Faster R-CNN R50-FPN, 80 classes) and detr (R50 + a 6 / 6
     transformer, 91 classes) each give a loss and an image gradient on
     the card (finite, nonzero; their time), and their head outputs, and
     their loss with the card's discrete choices replayed, match the same
     module moved to the CPU (max rel 1e-4); then
     `run_dagger` against each, 4 PGD iterations on the colours, with the
     blend launch counts set to 0 just before and read just after (both
     above 0), its PGD it/s and the loss-and-step iteration's device busy
     share; then yolov3, yolov5 (v5s) and yolov11 (v11n) each give a loss
     and image gradient at imgsz 640, finite and nonzero.
  7. Training and CLOAK on the blend kernels. (a) One `Trainer` step with
     the grouping regulariser on, from one state, on the card and on the
     CPU (10k splats, 256x256): loss (rel 1e-5), every parameter gradient
     and the mean2d gradient (max rel 1e-3); then one `densify_and_prune`
     of the card's state on both, with the same draws and a threshold at
     the lower quartile of the gradients: `alive` and the dropped count
     (above 0) equal, parameters and moments within 1e-6; and the same
     through `Trainer.maybe_densify`, which grows the capacity: equal
     capacities and states within 1e-6. (b) Phase
     4's scene (100k splats, SH3) moved by -6 in z, 9 orbiting views at
     800x800: a COLMAP text model of 8 + 1 views and the scene's noisy
     centres goes out and back through `load_scene_info` (cameras within
     1e-6), `scene_from_points` makes the initial scene with the 3-NN op
     on the card (timed), and `Trainer.fit` runs `train_config`'s 600
     steps with checkpoints every 300; gates: finite losses, the last 50
     steps' mean loss below the first 50's, the held-out PSNR up, densify
     changing the alive count, SH degree 3, at least one launch of each
     blend kernel a step, both checkpoints restored equal. (On this scene
     densify prunes more than it adds, so the capacity does not fill:
     (a)'s pass, at a lower-quartile threshold, grows it through
     `Trainer.maybe_densify`, card against CPU.) Prints train it/s, the densify passes, the largest
     `num_truncated_pairs` of a step, the busy share of 10 profiled steps
     and a step's stages. (c) `run_cloak` against yolov8n@640 (seed 0):
     2 of the 8 views poisoned by `CloakConfig`'s defaults, then 200 steps
     of retraining from (b)'s initial scene; gates: each poisoned view
     within epsilon and [0, 1] and changed, its targeted loss (the clean
     view's assignment replayed, float64) below the clean view's, the
     scene finite, the blend launched each step. Prints the poison time
     per view and the retraining it/s.

  8. The command line (`gsattack_torch.cli.main([..., "--device",
     "cuda"])`, in this process, the blend's launch counters set to 0
     before each command and read after it) on phase 7's target and its 9
     views, through files. (a) A COLMAP text model with GT PNGs written by
     `io/png.py` from the renders, and the noisy centres; `load_scene_info`
     reads the frames back equal to the uint8 renders. (b) `train`, 300
     steps, phase 7b's schedule cuts halved (`CLI_TRAIN_REDUCED`; no
     opacity reset falls in the run): rc 0,
     the iteration-300 PLY read back finite, each blend kernel launched at
     least once a step; prints train it/s over the command's wall time.
     (c) `attack` in the default config's mode C (the trained PLY attacked
     over a seeded 100k-splat background PLY), yolov8n@640 (seed 0), car,
     4 yaw-augmented views in one batch, max_iters 5: rc 0 or 1 (no
     success, as seeded weights give), max_iters - 1 finite losses unless
     it succeeded, both kernels launched, the combined scene the two PLYs'
     splats, a silhouette box in each attack view; prints PGD it/s from
     the per-iteration lines. (d)
     `render-eval` on the trained scene and on the attack's final scene
     (saved as a PLY), all 9 cameras: 9 records in each log, each with a
     silhouette GT box, 18 forward
     launches and no backward a run; prints seconds per camera. (e) `asr`
     and `coco-ap` over the two logs: rc 0, 9 cameras parsed from each.
     (f) `recolor` in its four modes (f_rest zero on read-back), `combine`
     of the two PLYs over the 9 cameras (9 PNGs of 800x800, 9 forward
     launches), `grouping-render` (9 frames; no video without OpenCV),
     and the convex hull of the x < 0 splats, timed. `predict-batch` and
     `write_images=true` stay out: their annotated images are drawn by
     Pillow, which the port does not depend on (phase 8's summary says
     whether the card's machine has it, and OpenCV).

  9. The (views, splats) mesh (`gsattack_torch.parallel`), each rank a
     spawned process on this card that loads phase 1's kernel library.
     (a) 4 gloo ranks of a (2, 2) mesh, all on cuda:0 (gloo takes the
     CUDA tensors and copies them through host memory): the sharded render
     of phase 4's scene (100k splats, SH3, 4 views at 800x800, bands
     planned from measured pair costs) against the unsharded one on the
     card, RGB and 19 channels (images 1e-5 abs, every attribute gradient
     1e-3 max rel), then phase 4's `run_dagger` on the mesh against phase
     4's run (losses 1e-4 rel) with its PGD it/s, and for its first 3
     PGD iterations against the unsharded run's (f_dc 1e-5 abs). (b) 2 gloo ranks of a (1, 2) mesh: `Trainer(mesh)`
     for the first 150 steps of phase 7b's schedule (one densify pass)
     against `Trainer()` on the
     card (losses 1e-3 max rel), then phase 7a's gates from `Trainer()`'s
     final state: one step's loss (1e-5 rel) and gradients (1e-3 max
     rel), and a densify pass at a lower-quartile threshold that grows
     the capacity (states equal within 1e-6); train it/s of both. (c) One
     NCCL rank, a (1, 1) mesh: phase 6's `run_dagger` against
     yolov8n@640 on the mesh (losses 1e-4 rel against phase 6's), its PGD
     it/s. Each rank's launch counts are set to 0 just before its main
     path and read just after; every rank must launch both blend kernels.
 10. `utils/profiling.py` and `utils/viewer.py`: two PGD iterations of
     phase 4's scene under `trace_to`, each stage an `annotate` span and a
     `StageTimer` stage (the trace names every span and holds kernel
     events; the summary lists every stage); `serve_scene` in a daemon
     thread answers two `request_frame` calls over localhost with frames
     equal to `render` of the request's camera in RGB8.
 11. The static caps (`phase_caps`): (a) phase 4's `run_dagger` on the
     "pallas" route with every cap at -1, sized by the probes (printed),
     no pair truncated at those sizes, losses and f_dc against phase 4's
     (1e-4 rel, 1e-5 abs; bit-equal expected and printed), PGD it/s; (b)
     view 0 at half the probed pairs_budget, compact_budget and
     heavy_budget: each cap's dropped pairs above 0 and equal to the CPU
     binning's, both kernels against the plain version under all three
     (phase 3's gates); (c) `Trainer` with `auto_caps`-sized caps for 50
     steps of phase 7b's schedule: finite losses, every blend kernel
     launched each step; then `gather_sum_rows` on the slot table of the
     trainer's first step at those caps (`trainer_slot_table`, 110,000 x
     2500), equal to its plain version, timed with its bound.

Prints the card's line and the kernels as one JSON line, then the ok
line last.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and fp32
# (non-tensor-core) rate. The blend's exp goes to the SFUs, counted here as
# one fp32 operation.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# fp32 operations per (pixel, pair) as blend.cu does them, an FMA counted
# as two and the exp as one. Every evaluated pair pays the alpha test:
# power 11, alpha 4, the two skip tests 2. A live (composited) pair adds,
# in the forward, the transmittance test 3, the weight 1 and 2 per channel;
# in the backward, the T recovery 2, the weight 1, dalpha 3, the suffix 2,
# the clamp 2, the five geometry gradients 17, the opacity 1, 3 per
# channel, and its share of the sum over the tile's pixels, one add for
# each of its 6 + CH values. A pixel's stopping pair adds the forward's
# transmittance test.
OPS_ALPHA = 17
OPS_FWD_LIVE = lambda ch: 4 + 2 * ch  # noqa: E731
OPS_FWD_STOP = 3
OPS_BWD_LIVE = lambda ch: 34 + 4 * ch  # noqa: E731

GATE_IMAGE = 1e-5
GATE_GRAD = 1e-3
# The time of the fused backward with atomics that blend_bwd +
# gather_sum_rows replace, at phase 3's shapes, as phase 3 measured it on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table).
FUSED_BWD_MS = 0.8637
CHUNK, MAX_CHUNKS = 128, 16
EDGE_BATCHES = (32, 64)  # pairs staged per step: blend.cu's BWD_BATCH, FWD_BATCH
# The row gather's sizes: the 500k-splat scene's gathers, as the JAX
# package's scripts/micro_gather.py defaults give them.
GATHER_S, GATHER_M = 1_787_904, 2_217_984
GATHER_WIDTHS = (16, 32, 40)
# The plain version holds (tiles, chunk, 256) temporaries per chunk: at the
# main path's 10k tiles it runs 64-pair chunks, with the same 2048-pair cap.
PLAIN_CHUNK, PLAIN_MAX_CHUNKS = 64, 32
# Phase 6: the detectors run at full width on the main path's views, each
# by its family's defaults; card against CPU, heads and loss, relative.
MAIN_DETECTORS = ("yolov8", "detectron2", "detr")
OTHER_YOLOS = ("yolov3", "yolov5", "yolov11")
DETECTOR_PGD_ITERS = 4
GATE_DETECTOR = 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms, by CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_scene(n: int, seed: int, knn: float, device, anisotropic: bool = False):
    """A seeded synthetic scene: points ~ N(0, diag(2, 2, 1)) around z = 6,
    SH degree 3 with small rest coefficients, N(0, 1) opacity logits, and
    (`anisotropic`) perturbed scales and rotations."""
    import torch

    from gsattack_torch.core.scene import scene_from_points

    g = torch.Generator().manual_seed(seed)
    pts = torch.randn((n, 3), generator=g) * torch.tensor([2.0, 2.0, 1.0]) + torch.tensor(
        [0.0, 0.0, 6.0]
    )
    cols = torch.rand((n, 3), generator=g) * 0.9 + 0.05
    scene = scene_from_points(
        pts.numpy(), cols.numpy(), max_sh_degree=3, generator=g,
        knn_dist2=torch.full((n,), knn).numpy(), device=device,
    )
    scene = scene.replace(
        active_sh_degree=3,
        f_rest=(torch.randn(scene.f_rest.shape, generator=g) * 0.02).to(device),
        opacity_logit=torch.randn((n, 1), generator=g).to(device),
    )
    if anisotropic:
        scene = scene.replace(
            log_scale=scene.log_scale + (torch.randn((n, 3), generator=g) * 0.3).to(device),
            quat=scene.quat + (torch.randn((n, 4), generator=g) * 0.2).to(device),
        )
    return scene


def base_camera(width: int, height: int):
    import numpy as np

    from gsattack_torch.core.camera import CameraExtrinsics

    return CameraExtrinsics(np.eye(3), np.zeros(3), 1.0, 1.0 * height / width, width, height)


def main_shapes(device):
    """The main path's scene (100k splats, SH3), its base camera (800x800),
    the 4 yaw-augmented views run_dagger renders, and the per-gaussian pair
    capacity its -1 resolves to."""
    import torch

    from gsattack_torch.attack import expand_viewpoints
    from gsattack_torch.core.camera import stack_cameras
    from gsattack_torch.ops.project import project
    from gsattack_torch.ops.raster import auto_pairs_per_gaussian

    scene = build_scene(100_000, seed=0, knn=1e-4, device=device)
    ext = base_camera(800, 800)
    cams = stack_cameras([v.build(device=device) for v in expand_viewpoints([ext], 4)])
    with torch.no_grad():
        pairs = max(
            auto_pairs_per_gaussian(project(scene, cams.view_at(i)), 800, 800)
            for i in range(cams.num_views)
        )
    return scene, ext, cams, pairs


def blend_inputs(scene, cams, pairs_per_gaussian: int, grad_scene: bool):
    """Project every view and bin it: the blend's inputs (with autograd
    back to the scene's parameters when `grad_scene`) and the bins."""
    import torch

    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import bin_views

    leaves = {k: v.detach().clone().requires_grad_(grad_scene) for k, v in scene.params().items()}
    sc = scene.with_params(leaves)
    proj = stack_projections([project(sc, cams.view_at(i)) for i in range(cams.num_views)])
    bins = bin_views(proj, cams.width, cams.height, pairs_per_gaussian)
    chans = torch.cat([proj.color, proj.obj], dim=-1)
    blend_in = [proj.mean2d, proj.conic, proj.opacity, chans]
    if not grad_scene:
        blend_in = [x.detach().contiguous().requires_grad_(True) for x in blend_in]
    return leaves, proj, bins, blend_in


def truncated(bins) -> int:
    return int(((bins.tile_end - bins.tile_start).long() - CHUNK * MAX_CHUNKS).clamp(min=0).sum())


def pair_work(idx, blend_in, tiles, cap: int, last, chunk: int = 32) -> dict:
    """The (pixel, pair) work the kernels do on these inputs, from the
    forward kernel's `last`: `fwd_eval` pairs whose alpha the forward
    computes (a pixel's pairs up to the one that stops it, else its tile's
    whole capped range), `stops` the pixels stopped, `bwd_eval` the pairs
    the backward computes (those below the pixel's `last`), `live` the
    composited pairs among them, `clamped` the live pairs whose alpha the
    0.99 cap clips, and `warp_live` the backward's (warp, pair) steps with a
    live lane, a warp being one of the tile's 8 two-row groups of 32
    pixels: the steps that sum gradients over the warp. Plain PyTorch in
    the kernels' operation order."""
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
    px = ((tid % tiles_x)[:, None] * 16 + pix % 16).float()[:, None, :]  # (M, 1, 256)
    py = ((tid // tiles_x)[:, None] * 16 + pix // 16).float()[:, None, :]
    last_t = (last.reshape(v, tiles_y, 16, tiles_x, 16).permute(0, 1, 3, 2, 4)
              .reshape(m, 1, 256).long())
    stop = torch.full((m, 256), cap, dtype=torch.long, device=dev)
    live = clamped = warp_live = 0
    for k0 in range(0, int(count.max()), chunk):
        j = torch.arange(k0, k0 + chunk, device=dev)
        valid = (j[None, :] < count[:, None])[..., None]  # (M, K, 1)
        g = geom[gauss_idx[(start[:, None] + j).clamp(max=gauss_idx.shape[0] - 1)].long()]
        dx, dy = px - g[..., 0:1], py - g[..., 1:2]  # (M, K, 256)
        power = -0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) - g[..., 3:4] * dx * dy
        alpha_pre = g[..., 5:6] * torch.exp(power.clamp(max=0.0))
        use = (power <= 0.0) & (alpha_pre.clamp(max=0.99) >= 1.0 / 255.0) & valid
        below = j[None, :, None] < last_t
        live += int((use & below).sum())
        clamped += int((use & below & (alpha_pre > 0.99)).sum())
        warp_live += int((use & below).reshape(m, chunk, 8, 32).any(-1).sum())
        # The first live pair at or past `last` is the one that stopped
        # the pixel: had it passed the transmittance test, it would have
        # been composited.
        j_past = torch.where(use & ~below, j[None, :, None], cap)
        stop = torch.minimum(stop, j_past.amin(dim=1))
    stopped = stop < cap
    return {
        "fwd_eval": int(torch.where(stopped, stop + 1, count[:, None]).sum()),
        "stops": int(stopped.sum()),
        "bwd_eval": int(last.long().sum()),
        "live": live,
        "clamped": clamped,
        "warp_live": warp_live,
    }


def bwd_shuffles(ch: int) -> tuple[int, int]:
    """Warp shuffles per (warp, pair) step with a live lane, summing the
    6 + CH gradient values over the warp: by a 5-step butterfly per value,
    and by the kernel's reduce-scatter over the values padded to 32 (31
    shuffles) or 16 (15, then one to add the two half-warps)."""
    nv = 6 + ch
    return 5 * nv, 31 if nv > 16 else 16


def phase_small(device, tx_ty):
    """Phase 2: kernel vs plain, blend and scene-parameter gradients."""
    import torch

    from gsattack_torch.core.camera import stack_cameras
    from gsattack_torch.ops import blend
    from gsattack_torch.ops.raster import blend_tiles_plain

    w = h = 256
    n = 10_000
    scene = build_scene(n, seed=1, knn=1e-3, device=device, anisotropic=True)
    # A fifth of the splats nearly opaque (logit 6, opacity 0.9975), so that
    # pairs near their centres pass the 0.99 cap: the backward's clamp and
    # its T / (1 - alpha) recovery at alpha = 0.99 are then exercised.
    hot = torch.rand((n, 1), generator=torch.Generator().manual_seed(4)) < 0.2
    scene = scene.replace(
        opacity_logit=torch.where(hot.to(device), 6.0, scene.opacity_logit)
    )
    ext = base_camera(w, h)
    cams = stack_cameras([ext.build(device=device), ext.yaw(7.0).build(device=device)])
    leaves, _, bins, blend_in = blend_inputs(scene, cams, 32, grad_scene=True)
    if truncated(bins):
        raise AssertionError(f"phase 2 scene truncates {truncated(bins)} pairs")
    tiles = tx_ty(w, h)
    idx = (bins.gauss_idx, bins.tile_start, bins.tile_end)
    cap = CHUNK * MAX_CHUNKS
    with torch.no_grad():
        plain_in = [x.detach().contiguous() for x in blend_in]
        last = blend.forward_kernel(*idx, *plain_in, *tiles, cap)[2]
        work = pair_work(idx, plain_in, tiles, cap, last)
    if work["clamped"] == 0:
        raise AssertionError("phase 2 has no live pair past the 0.99 cap")
    g = torch.Generator(device=device).manual_seed(2)
    w_img = torch.randn((2, tiles[1] * 16, tiles[0] * 16, 19), generator=g, device=device)
    w_t = torch.randn((2, tiles[1] * 16, tiles[0] * 16), generator=g, device=device)
    wrt = blend_in + list(leaves.values())
    names = ["d_mean2d", "d_conic", "d_opacity", "d_colour"] + [f"d_{k}" for k in leaves]
    results = {}
    for route in ("kernel", "plain"):
        if route == "kernel":
            img, T = blend.blend(*idx, *blend_in, *tiles, cap, bins.slot_table)
        else:
            img, T = blend_tiles_plain(*idx, *blend_in, *tiles, PLAIN_CHUNK, PLAIN_MAX_CHUNKS,
                                       bins.slot_table)
        loss = (img * w_img).sum() + (T * w_t).sum()
        grads = torch.autograd.grad(loss, wrt, retain_graph=True, allow_unused=True)
        results[route] = (img.detach(), T.detach(), grads)
    (img_k, T_k, g_k), (img_p, T_p, g_p) = results["kernel"], results["plain"]
    err = {
        "image": float((img_k - img_p).abs().max()),
        "T": float((T_k - T_p).abs().max()),
    }
    for name, a, b in zip(names, g_k, g_p):
        if b is None:
            continue
        err[name] = max_rel(a, b)
    log("phase 2  kernel vs plain (10k splats, a fifth nearly opaque, 256x256, 2 views, 19 ch, "
        f"{bins.gauss_idx.shape[0]} pairs, 0 truncated; {work['live']} live pixel-pairs, "
        f"{work['clamped']} of them past the 0.99 cap):")
    for k, v in err.items():
        log(f"  {k:16s} {'max abs' if k in ('image', 'T') else 'max rel'} {v:.3e}")
    bad = {k: v for k, v in err.items() if v > (GATE_IMAGE if k in ("image", "T") else GATE_GRAD)}
    if bad or not all(math.isfinite(v) for v in err.values()):
        raise AssertionError(f"phase 2 gate failed: {bad}")
    return err


def kernel_grads(idx, plain_in, tiles, T, last, g_img, g_t, slot_table=None):
    """The kernels' backward as autograd runs it: `blend_bwd`'s per-pair
    rows summed by gaussian over the slot table by `gather_sum_rows`
    (`slot_table_of` the pair list when not given). Returns (the four
    per-gaussian gradients, the per-pair rows, the slot table). A
    checkout whose backward kernel sums per gaussian itself (as
    `scripts/blend_ab.py`'s parent may) gives its gradients and None."""
    from gsattack_torch.ops import blend

    rows = blend.backward_kernel(*idx, *plain_in, *tiles, T, last, g_img, g_t)
    if not hasattr(rows, "shape"):
        return rows, None, None
    from gsattack_torch.ops.gather_sum import gather_sum_rows
    from gsattack_torch.ops.raster import slot_table_of

    v, n, _ = plain_in[3].shape
    if slot_table is None:
        slot_table = slot_table_of(*idx, v * n)
    grads = blend.split_rows(gather_sum_rows(rows, slot_table), v, n)
    return grads, rows, slot_table


def kernels_vs_plain(idx, blend_in, tiles, cap: int,
                     plain_chunks=(PLAIN_CHUNK, PLAIN_MAX_CHUNKS), seed: int = 3,
                     slot_table=None) -> dict:
    """Both kernels against the plain version on the same inputs: the
    forward kernel's image and T, and the backward kernels' gradients
    (`kernel_grads`) for seeded random output gradients against the plain
    version's autograd (`blend_in` must require grad), both over
    `slot_table` when given. Returns the errors (image/T max abs,
    gradients max abs and max rel each), the forward's (T, last), the
    output gradients, the per-pair rows and the slot table, and the plain
    loss, whose autograd is the plain backward."""
    import torch

    from gsattack_torch.ops import blend
    from gsattack_torch.ops.raster import blend_tiles_plain

    plain_in = [x.detach() for x in blend_in]
    with torch.no_grad():
        img_k, T_k, last = blend.forward_kernel(*idx, *plain_in, *tiles, cap)
    g = torch.Generator(device=img_k.device).manual_seed(seed)
    g_img = torch.randn(img_k.shape, generator=g, device=img_k.device)
    g_t = torch.randn(T_k.shape, generator=g, device=img_k.device)
    grads_k, rows, table = kernel_grads(idx, plain_in, tiles, T_k, last, g_img, g_t, slot_table)
    extra = () if slot_table is None else (slot_table,)
    img_p, T_p = blend_tiles_plain(*idx, *blend_in, *tiles, *plain_chunks, *extra)
    out_p = (img_p * g_img).sum() + (T_p * g_t).sum()
    grads_p = torch.autograd.grad(out_p, blend_in, retain_graph=True)
    names = ("d_mean2d", "d_conic", "d_opacity", "d_colour")
    return {
        "fwd_err": max(float((img_k - img_p.detach()).abs().max()),
                       float((T_k - T_p.detach()).abs().max())),
        "bwd_abs": max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p)),
        "bwd_rel": {k: max_rel(a, b) for k, a, b in zip(names, grads_k, grads_p)},
        "T": T_k, "last": last, "g_img": g_img, "g_T": g_t, "plain_out": out_p,
        "grads": grads_k, "rows": rows, "slot_table": table,
    }


def edge_tile_counts() -> list[int]:
    """Pairs per tile of phase 2b's view: an empty tile; 1, B - 1, B and
    B + 1 for each staging batch B of the kernels; 2047, 2048 and 2049
    around the 2048-pair cap."""
    cap = CHUNK * MAX_CHUNKS
    counts = {0, cap - 1, cap, cap + 1}
    for b in EDGE_BATCHES:
        counts |= {1, b - 1, b, b + 1}
    return sorted(counts)


def edge_tile_inputs(ch: int, seed: int = 7) -> dict:
    """One view of blend inputs built directly, seeded with numpy: tile i of
    a one-row strip holds `edge_tile_counts()[i]` pairs, each pair its own
    gaussian, stored in a shuffled order. In the tiles of up to 65 pairs the
    means lie in and around the tile, with PD conics and opacities 0.05-0.7,
    and every 8th pair is a narrow splat at opacity 0.999 centred on a pixel
    (where the 0.99 cap clips it). In the tiles near the cap one pair in 16
    lies on the tile at opacity 0.02-0.3 and the rest lie 40 px or more
    below it (evaluated, never live), so that pixels stay open up to the
    cap. The last three pairs of every tile cover it (sigma 14 px, opacity
    0.5): an open pixel composites the tile's last pair, and a 2049th pair
    would show if the cap let it through. The geometry does not depend on
    `ch`. Returns the blend's arrays (one view) as numpy and the tile
    grid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = edge_tile_counts()
    fields = {"mean2d": [], "conic": [], "opacity": [], "colors": []}
    for i, cnt in enumerate(counts):
        x0 = 16.0 * i
        mean = rng.uniform(-4, 20, size=(cnt, 2))
        mean[:, 0] += x0
        a, c = rng.uniform(0.01, 0.3, size=(2, cnt))
        b = rng.uniform(-0.5, 0.5, size=cnt) * np.sqrt(a * c)
        op = rng.uniform(0.05, 0.7, size=cnt)
        if cnt > 2 * max(EDGE_BATCHES):
            far = rng.uniform(size=cnt) >= 1 / 16
            mean[far, 1] = rng.uniform(56, 76, size=int(far.sum()))
            a[far] = c[far] = rng.uniform(0.05, 0.3, size=int(far.sum()))
            b[far] = 0.0
            op[~far] = rng.uniform(0.02, 0.3, size=int((~far).sum()))
        else:
            hot = np.arange(cnt) % 8 == 3
            mean[hot] = np.stack([rng.integers(0, 16, int(hot.sum())) + x0,
                                  rng.integers(0, 16, int(hot.sum()))], -1)
            a[hot] = c[hot] = 0.5
            b[hot] = 0.0
            op[hot] = 0.999
        cover = np.arange(cnt) >= cnt - 3
        mean[cover] = (x0 + 7.5, 7.5)
        a[cover] = c[cover] = 0.005
        b[cover] = 0.0
        op[cover] = 0.5
        fields["mean2d"].append(mean)
        fields["conic"].append(np.stack([a, b, c], -1))
        fields["opacity"].append(op)
    n = sum(counts)
    fields["colors"].append(rng.uniform(size=(n, ch)))  # after the geometry: the same at any CH
    perm = rng.permutation(n)  # pair p is gaussian perm[p]
    out = {}
    for k, parts in fields.items():
        by_pair = np.concatenate(parts).astype(np.float32)
        stored = np.empty_like(by_pair)
        stored[perm] = by_pair
        out[k] = stored[None]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out["gauss_idx"] = perm.astype(np.int32)
    out["tile_start"] = start.astype(np.int32)[None]
    out["tile_end"] = (start + counts).astype(np.int32)[None]
    out["tiles"] = (len(counts), 1)
    return out


def phase_edge_tiles(device) -> dict:
    """Phase 2b: both kernels against the plain version (the same 2048-pair
    cap) on `edge_tile_inputs`, at 3 and 19 channels."""
    import torch

    cap = CHUNK * MAX_CHUNKS
    counts = edge_tile_counts()
    log(f"phase 2b kernel vs plain on built tiles of {counts} pairs (1 view, cap {cap}):")
    errs = {}
    for ch in (3, 19):
        e = edge_tile_inputs(ch)
        idx = [torch.from_numpy(e[k]).to(device) for k in ("gauss_idx", "tile_start", "tile_end")]
        blend_in = [torch.from_numpy(e[k]).to(device).requires_grad_(True)
                    for k in ("mean2d", "conic", "opacity", "colors")]
        tiles = e["tiles"]
        cmp = kernels_vs_plain(idx, blend_in, tiles, cap, plain_chunks=(CHUNK, MAX_CHUNKS))
        last = cmp["last"]
        with torch.no_grad():
            work = pair_work(idx, [x.detach() for x in blend_in], tiles, cap, last)
        # The deepest last contributor of each tile: where the backward's
        # walk starts.
        deepest = last.reshape(16, tiles[0], 16).amax(dim=(0, 2)).tolist()
        log(f"  CH={ch:2d}: image/T max abs {cmp['fwd_err']:.3e}; gradients max rel "
            + ", ".join(f"{k} {v:.3e}" for k, v in cmp["bwd_rel"].items())
            + f"; {work['live']} live pixel-pairs, {work['clamped']} past the 0.99 cap; "
            f"deepest last contributor per tile {deepest}")
        want = [min(c, cap) for c in counts]
        if (cmp["fwd_err"] > GATE_IMAGE or max(cmp["bwd_rel"].values()) > GATE_GRAD
                or work["clamped"] == 0 or deepest != want):
            raise AssertionError(f"phase 2b failed at CH={ch}: image/T {cmp['fwd_err']}, "
                                 f"grads {cmp['bwd_rel']}, clamped {work['clamped']}, "
                                 f"deepest {deepest} (want {want})")
        errs[ch] = {"fwd_err": cmp["fwd_err"], **cmp["bwd_rel"]}
    return errs


def gather_sum_edges(device) -> dict:
    """`gather_sum_rows` on its edge cases, at W of 1, 9, 25 (3 and 19
    channels), 40 and 70 (past the kernel's 64-column pass): c = 1, a row
    of -1 only, N = 0 (no launch), repeated slots, c = 33, c = 700 and c =
    2500 (tables wider than a chunk: rows that share a chunk, and rows
    over several chunks), 509 gaussians at c = 12 (a prime, so no
    multiple of a CTA's gaussian block), every slot named (c = 12 and c =
    2500), one pair named along whole rows; each equal to the plain version
    (`torch.equal`), with one launch (none for N = 0)."""
    import torch

    from gsattack_torch.ops import gather_sum

    g = torch.Generator().manual_seed(12)
    p = 600

    def sparse(n, c, named=0.15):
        t = torch.randint(0, p, (n, c), generator=g)
        return torch.where(torch.rand((n, c), generator=g) < named, t, -1)

    out = {}
    for w in (1, 9, 25, 40, 70):
        rows = torch.randn((p, w), generator=g).to(device)
        cases = {
            "c=1": torch.randint(-1, p, (33, 1), generator=g),
            "all -1 row": torch.cat([torch.randint(-1, p, (7, 5), generator=g),
                                     torch.full((1, 5), -1)]),
            "N=0": torch.zeros((0, 4), dtype=torch.int64),
            "repeated slots": torch.tensor([[3, 3, 3, -1], [7, -1, 7, 7], [0, 1, 0, 1]]),
            "c=33": sparse(509, 33),
            "c=700": sparse(40, 700),
            "c=2500": sparse(5, 2500),
            "N=509, c=12": sparse(509, 12),
            "every slot named, c=12": sparse(509, 12, named=1.0),
            "every slot named, c=2500": sparse(3, 2500, named=1.0),
            "one pair along a row": torch.tensor([[7] * 40, [-1] * 20 + [3] * 20, [5, -1] * 20]),
        }
        for name, table in cases.items():
            table = table.to(torch.int32).to(device)
            before = launch_counts()["gather_sum"]
            got = gather_sum.gather_sum_rows(rows, table)
            launched = launch_counts()["gather_sum"] - before
            equal = torch.equal(got, gather_sum.gather_sum_rows_plain(rows, table))
            out[f"W={w} {name}"] = equal and launched == (0 if name == "N=0" else 1)
    torch.cuda.synchronize()
    bad = [k for k, ok in out.items() if not ok]
    log(f"  gather_sum_rows edge cases (equal to plain, launches as expected): "
        f"{len(out) - len(bad)} of {len(out)}")
    if bad:
        raise AssertionError(f"gather_sum_rows edge cases failed: {bad}")
    return out


def bound(nbytes, ops) -> tuple[float, str]:
    """The least time in ms for `nbytes` moved and `ops` fp32 operations
    done at the card's peak rates, and which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sum_bytes(table, w: int) -> int:
    """The bytes `gather_sum_rows` must move: the table, each named row of
    w floats once, each output row once."""
    return (table.numel() + (int((table >= 0).sum()) + table.shape[0]) * w) * 4


def phase_main_shapes(scene, cams, pairs, tx_ty):
    """Phase 3: both blend kernels and the backward's per-gaussian sum
    against the plain version at the main path's shapes, with their times
    and bounds, and `index_add_`'s time for the sum."""
    import torch

    from gsattack_torch.ops import blend
    from gsattack_torch.ops.gather_sum import gather_sum_rows, gather_sum_rows_plain
    from gsattack_torch.ops.raster import blend_tiles_plain

    _, proj, bins, blend_in = blend_inputs(scene, cams, pairs, grad_scene=False)
    tiles = tx_ty(cams.width, cams.height)
    v, n, ch = blend_in[3].shape
    cap = CHUNK * MAX_CHUNKS
    idx = (bins.gauss_idx, bins.tile_start, bins.tile_end)
    table = bins.slot_table
    plain_in = [x.detach() for x in blend_in]
    cmp = kernels_vs_plain(idx, blend_in, tiles, cap, slot_table=table)
    T_k, last, g_img, g_t = cmp["T"], cmp["last"], cmp["g_img"], cmp["g_T"]
    fwd_err, bwd_abs, bwd_rel = cmp["fwd_err"], cmp["bwd_abs"], cmp["bwd_rel"]
    rows, out_p = cmp["rows"], cmp["plain_out"]
    log(f"phase 3  kernel vs plain at the main path's shapes ({n} splats, "
        f"{cams.width}x{cams.height}, {v} views, {ch} ch, {bins.gauss_idx.shape[0]} pairs, "
        f"{truncated(bins)} truncated, {int(bins.num_culled_pairs)} culled; slot table "
        f"{tuple(table.shape)}, {int((table >= 0).sum())} slots named):")
    log(f"  image/T max abs {fwd_err:.3e}; gradients (blend_bwd + gather_sum_rows) max rel "
        + ", ".join(f"{k} {e:.3e}" for k, e in bwd_rel.items()))
    if fwd_err > GATE_IMAGE or max(bwd_rel.values()) > GATE_GRAD:
        raise AssertionError(f"phase 3 gate failed: image/T {fwd_err}, grads {bwd_rel}")
    # The per-gaussian sum alone against its plain version, bit for bit,
    # and against index_add_ (which sums with atomics) to rounding.
    gidx = bins.gauss_idx.long()
    with torch.no_grad():
        summed = gather_sum_rows(rows, table)
        sum_equal = torch.equal(summed, gather_sum_rows_plain(rows, table))
        library = torch.zeros_like(summed).index_add_(0, gidx, rows)
    sum_err = float((summed - library).abs().max())
    if not sum_equal:
        raise AssertionError("phase 3: gather_sum_rows differs from its plain version")
    gather_sum_edges(plain_in[0].device)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: blend.forward_kernel(*idx, *plain_in, *tiles, cap), reps=10)
        bwd_ms = cuda_ms(
            lambda: blend.backward_kernel(*idx, *plain_in, *tiles, T_k, last, g_img, g_t), reps=10
        )
        sum_ms = cuda_ms(lambda: gather_sum_rows(rows, table), reps=10)
        both_ms = cuda_ms(
            lambda: kernel_grads(idx, plain_in, tiles, T_k, last, g_img, g_t, table), reps=10
        )
        acc = torch.zeros_like(summed)
        library_ms = cuda_ms(lambda: acc.index_add_(0, gidx, rows), reps=10)
        plain_sum_ms = cuda_ms(lambda: gather_sum_rows_plain(rows, table), reps=3)
        plain_fwd_ms = cuda_ms(
            lambda: blend_tiles_plain(*idx, *plain_in, *tiles, PLAIN_CHUNK, PLAIN_MAX_CHUNKS,
                                      table), reps=2
        )
    plain_bwd_ms = cuda_ms(
        lambda: torch.autograd.grad(out_p, blend_in, retain_graph=True), reps=2
    )

    # Bounds from this run's inputs: each input read once, each output
    # written once; the (pixel, pair) work these inputs need. The backward
    # writes one row of 6 + CH floats per pair, which the sum reads back
    # (the rows the table names, once each) with the table.
    with torch.no_grad():
        work = pair_work(idx, plain_in, tiles, cap, last)
    n_pairs = bins.gauss_idx.shape[0]
    per_gauss = v * n * (6 + ch) * 4
    pair_rows = n_pairs * (6 + ch) * 4
    named = int((table >= 0).sum())
    pixels = T_k.numel()
    ranges = 2 * bins.tile_start.numel() * 4
    fwd_bytes = 4 * n_pairs + ranges + per_gauss + pixels * (ch + 2) * 4
    bwd_bytes = 4 * n_pairs + ranges + per_gauss + pixels * (ch + 3) * 4 + pair_rows
    sum_b = sum_bytes(table, 6 + ch)
    fwd_ops = (work["fwd_eval"] * OPS_ALPHA + work["live"] * OPS_FWD_LIVE(ch)
               + work["stops"] * OPS_FWD_STOP)
    bwd_ops = work["bwd_eval"] * OPS_ALPHA + work["live"] * OPS_BWD_LIVE(ch)
    sum_ops = named * (6 + ch)
    fwd_bound = bound(fwd_bytes, fwd_ops)
    bwd_bound = bound(bwd_bytes, bwd_ops)
    sum_bound = bound(sum_b, sum_ops)
    both_bound = bound(bwd_bytes + sum_b, bwd_ops + sum_ops)
    log("  pixel-pairs: " + ", ".join(f"{k} {val}" for k, val in work.items())
        + f"; fwd {fwd_bytes} B, {fwd_ops} ops; bwd {bwd_bytes} B, {bwd_ops} ops; "
        f"gather_sum {sum_b} B, {sum_ops} ops")
    per_step = bwd_shuffles(ch)
    shuffles = [work["warp_live"] * s for s in per_step]
    log(f"  backward (warp, pair) steps with a live lane: {work['warp_live']}; warp shuffles "
        f"to sum their {6 + ch} gradient values: {shuffles[0]} by a butterfly per value "
        f"({per_step[0]} a step), {shuffles[1]} by the reduce-scatter ({per_step[1]} a step)")
    log(f"  blend_fwd {fwd_ms:.4f} ms (plain {plain_fwd_ms:.1f} ms, bound {fwd_bound[0]:.4f} ms "
        f"by {fwd_bound[1]}); blend_bwd {bwd_ms:.4f} ms (bound {bwd_bound[0]:.4f} ms by "
        f"{bwd_bound[1]}); gather_sum_rows {sum_ms:.4f} ms (plain {plain_sum_ms:.3f} ms, bound "
        f"{sum_bound[0]:.4f} ms by {sum_bound[1]}; index_add_ {library_ms:.4f} ms, max abs "
        f"{sum_err:.2e} from it); the backward, both kernels, "
        f"{both_ms:.4f} ms (plain {plain_bwd_ms:.1f} ms, bound {both_bound[0]:.4f} ms by "
        f"{both_bound[1]}), against {FUSED_BWD_MS} ms for the fused atomic kernel it replaces")
    return {
        "n_pairs": n_pairs,
        "num_culled_pairs": int(bins.num_culled_pairs),
        "num_truncated_pairs": truncated(bins),
        "pixel_pairs": work,
        "bwd_shuffles": {"butterfly": shuffles[0], "reduce_scatter": shuffles[1]},
        "fwd": dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms,
                    bound_ms=fwd_bound[0], bound_by=fwd_bound[1]),
        "bwd": dict(max_abs_err=bwd_abs, max_rel_err=bwd_rel, ms=bwd_ms,
                    plain_ms=plain_bwd_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1]),
        "gather_sum": dict(max_abs_err=0.0 if sum_equal else float("inf"), ms=sum_ms,
                           plain_ms=plain_sum_ms, bound_ms=sum_bound[0],
                           bound_by=sum_bound[1], library_ms=library_ms,
                           library_max_abs_err=sum_err),
        "backward": dict(ms=both_ms, bound_ms=both_bound[0], bound_by=both_bound[1],
                         fused_atomic_ms=FUSED_BWD_MS),
        "rerun": lambda: kernel_grads(idx, plain_in, tiles, T_k, last, g_img, g_t, table)[0],
        "grads": cmp["grads"],
    }


def gather_bound(idx, w: int) -> tuple[int, float]:
    """The bytes a gather of rows of w floats by `idx` must move (each index
    read once, each distinct source row read once, each output row written
    once) and their time in ms at the card's memory rate: the gather
    computes nothing."""
    from gsattack_torch.scripts.micro_gather import distinct_rows, moved_bytes

    nbytes = moved_bytes(idx.numel(), w, distinct_rows(idx))
    return nbytes, nbytes / PEAK_BYTES_S * 1e3


def phase_gather(device) -> dict:
    """Phase 5: the row-gather kernel on edge cases and at the micro-bench's
    sizes against its plain version and `index_select`, then the
    micro-bench itself with the launch count read around it."""
    import torch

    from gsattack_torch.ops import gather
    from gsattack_torch.scripts import micro_gather

    bench = micro_gather.Bench(device, iters=10, seed=5)
    unaligned = torch.randn(301 * 4 + 1, generator=bench.gen, device=device)[1:].view(301, 4)
    repeated = torch.tensor([7] * 50 + [0, 49] * 25, dtype=torch.int32, device=device)
    cases = {
        "W=3 (scalar path)": (bench.table(97, 3), bench.indices(97, 300)),
        "W=4, source 4 B past 16 B alignment (scalar path)": (unaligned, bench.indices(301, 257)),
        "W=40": (bench.table(500, 40), bench.indices(500, 1001)),
        "W=3001 (a row wider than the grid's threads)": (bench.table(5, 3001),
                                                         bench.indices(5, 2)),
        "S=1": (bench.table(1, 16), bench.indices(1, 64)),
        "repeated indices": (bench.table(50, 16), repeated),
        "M=1": (bench.table(1000, 16), bench.indices(1000, 1)),
        "M=0": (bench.table(1000, 16), bench.indices(1000, 0)),
    }
    log("phase 5  row gather: edge cases against the plain version (torch.equal)")
    failed = []
    for name, (src, idx) in cases.items():
        before = launch_counts()["gather"]
        out = gather.gather_rows(src, idx)
        torch.cuda.synchronize()
        launched = launch_counts()["gather"] - before
        equal = torch.equal(out, gather.gather_rows_plain(src, idx))
        ok = equal and launched == (1 if idx.numel() else 0) and out.shape == (idx.numel(),
                                                                              src.shape[1])
        log(f"  {name:52s} {tuple(out.shape)} equal {equal}, launches {launched}")
        if not ok:
            failed.append(name)
    before = launch_counts()["gather"]
    try:  # M * W = 2^31 floats, from a view of one index: refused before any allocation
        gather.gather_rows(bench.table(1, 16),
                           torch.zeros(1, dtype=torch.int32, device=device).expand(2**27))
        refused = False
    except ValueError:
        refused = True
    log(f"  {'M * W = 2^31 (past the 32-bit piece index)':52s} refused {refused}, launches "
        f"{launch_counts()['gather'] - before}")
    if not refused or launch_counts()["gather"] != before:
        failed.append("M * W = 2^31")
    if failed:
        raise AssertionError(f"phase 5 edge cases failed: {failed}")

    idx = bench.indices(GATHER_S, GATHER_M)
    widths = {}
    log(f"  kernel vs plain vs index_select at S={GATHER_S}, M={GATHER_M} "
        f"({micro_gather.distinct_rows(idx)} distinct rows; device ms, mean of "
        f"{bench.iters} calls, L2 flushed before each):")
    for w in GATHER_WIDTHS:
        src = bench.table(GATHER_S, w)
        got = gather.gather_rows(src, idx)
        plain = gather.gather_rows_plain(src, idx)
        equal = torch.equal(got, plain) and torch.equal(got, torch.index_select(src, 0, idx))
        err = float((got - plain).abs().max())
        del got, plain
        nbytes, bound_ms = gather_bound(idx, w)
        row = dict(
            max_abs_err=err,
            ms=bench.ms(lambda: gather.gather_rows(src, idx)),
            plain_ms=bench.ms(lambda: gather.gather_rows_plain(src, idx)),
            library_ms=bench.ms(lambda: torch.index_select(src, 0, idx)),
            bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
        )
        widths[w] = row
        log(f"  W={w:2d} ({GATHER_S * w * 4 / 1e6:.1f} MB source) equal {equal}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, index_select "
            f"{row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B by bytes, "
            f"{row['ms'] / bound_ms:.2f}x)")
        if not equal:
            raise AssertionError(f"phase 5 gather differs at W={w}: max abs {err}")
        del src

    log("  micro-bench: python -m gsattack_torch.scripts.micro_gather main "
        "--threads 256 --in-flight 4 --iters 4")
    before = launch_counts()["gather"]
    rc = micro_gather.main(["main", "--threads", "256", "--in-flight", "4", "--iters", "4"])
    launches = launch_counts()["gather"] - before
    log(f"  micro-bench returned {rc}; gather launches {launches}")
    if rc != 0 or launches == 0:
        raise AssertionError(f"micro-bench: rc {rc}, gather launches {launches}")
    return {"widths": widths, "micro_bench_launches": launches}


def make_pgd_iter(scene, cams, det, pairs, bg, boxes):
    """One of run_dagger's loss-and-step iterations as a closure: the loss
    render, the detector's loss, the backward and the PGD step, without
    the eval render (the loop the profile traces). Each call steps from
    the last call's scene."""
    import torch

    from gsattack_torch.attack import render_views
    from gsattack_torch.attack.pgd import pgd_attack_step

    originals = {k: v.detach().clone() for k, v in scene.params().items()}
    state = {"scene": scene}

    def pgd_iter():
        leaves = {k: v.detach().requires_grad_(True) for k, v in state["scene"].params().items()}
        imgs = render_views(scene.with_params(leaves), cams, bg, pairs, MAX_CHUNKS, CHUNK)
        loss = det.loss(imgs, 2, boxes)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
        state["scene"] = pgd_attack_step(state["scene"], grads, originals, 0.5, 5.0)

    return pgd_iter


def profile_pgd(step, iters: int = 3, top: int = 12,
                what: str = "loss-and-step iterations (no eval render)") -> dict:
    """Device time by kernel over `iters` calls of `step` (by default PGD
    iterations; torch.profiler), and the device's busy share of the
    window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only: the rows of CPU-side operators repeat their
    # kernels' device time.
    rows = [
        (avg.key, float(avg.self_device_time_total), int(avg.count))
        for avg in prof.key_averages()
        if avg.device_type != torch.autograd.DeviceType.CPU and avg.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        log("  profile: the profiler saw no device time (not measured)")
        return {"busy_share": None, "top": []}
    log(f"  profile of {iters} {what}: device busy {busy_us / wall_us:.1%} of "
        f"{wall_us / 1e3 / iters:.2f} ms/iteration (profiler on), "
        f"{sum(r[2] for r in rows) // iters} kernels/iteration; top kernels by device time:")
    for name, dev_us, count in rows[:top]:
        log(f"    {dev_us / iters / 1e3:8.3f} ms/it  {dev_us / busy_us:6.1%}  x{count // iters:<4d} "
            f"{name[:90]}")
    return {
        "wall_ms_per_it": wall_us / 1e3 / iters,
        "busy_share": busy_us / wall_us,
        "top": [(n, d / iters / 1e3, c // iters) for n, d, c in rows[:top]],
    }


def stage_breakdown(scene, cams, det, pairs, bg, boxes, reps: int = 3) -> dict:
    """Host wall time of each stage of one PGD iteration, the card
    synchronised around every stage (launch overhead included), mean over
    `reps` iterations after a warm-up."""
    import torch

    from gsattack_torch.attack.pgd import pgd_attack_step
    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import bin_views, rasterize_views

    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    originals = scene.params()
    for r in range(reps + 1):
        if r == 1:
            ms.clear()
        leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        sc = scene.with_params(leaves)
        proj = timed("project, 4 views", lambda: stack_projections(
            [project(sc, cams.view_at(i)) for i in range(cams.num_views)]))
        timed("(bin_views alone, inside the next)", lambda: bin_views(
            proj, cams.width, cams.height, pairs))
        out = timed("rasterize_views: bin + blend fwd", lambda: rasterize_views(
            proj, cams.width, cams.height, bg, pairs, CHUNK, MAX_CHUNKS))
        loss = timed("detector loss", lambda: det.loss(out["render"], 2, boxes))
        grads = timed("backward (detector, blend, project)", lambda: dict(
            zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True))))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
        timed("pgd step", lambda: pgd_attack_step(scene, grads, originals, 0.5, 5.0))
    ms = {k: v / reps for k, v in ms.items()}
    total = sum(v for k, v in ms.items() if not k.startswith("("))
    log(f"  stages of one loss-and-step iteration ({total:.2f} ms, synchronised around each):")
    for k, v in ms.items():
        log(f"    {v:8.3f} ms  {k}")
    return ms


def main_attack_config(out_dir: str):
    """Phase 4's `run_dagger` settings (phase 9a runs them on the mesh)."""
    from gsattack_torch.attack import AttackConfig

    return AttackConfig(
        epsilon=5.0, alpha=0.5, max_iters=8, batch_size=4, add_cams=4, target=2,
        attributes=("color",), norm="l2", eval_every=1, attack_conf_thresh=0.99,
        pairs_per_gaussian=-1, chunk=CHUNK, max_chunks=MAX_CHUNKS, output_dir=out_dir,
    )


LAUNCH_COUNTERS = {"fwd": "blend_fwd_launches", "bwd": "blend_bwd_launches",
                   "gather_sum": "gather_sum_launches", "gather": "gather_launches"}
_launch_base: dict = {}


def launch_counts() -> dict:
    """The kernel launches since `zero_launch_counts`, from the program's
    counters (`gsattack_torch.utils.profiling.counters`)."""
    from gsattack_torch.utils.profiling import counters

    now = counters()
    return {k: now.get(name, 0) - _launch_base.get(name, 0)
            for k, name in LAUNCH_COUNTERS.items()}


def fewest_blend_launches(n: dict) -> int:
    """The fewest launches of the blend's kernels in `launch_counts()`'s
    counts: the forward, the backward and its per-gaussian sum."""
    return min(n["fwd"], n["bwd"], n["gather_sum"])


def zero_launch_counts() -> None:
    """Count `launch_counts` from here."""
    from gsattack_torch.utils.profiling import counters

    _launch_base.clear()
    _launch_base.update(counters())


def iteration_rate(stamps) -> float:
    """Iterations a second between the first and the last of a run's
    per-iteration host times (the first iteration, with its warm-up, left
    out)."""
    return (len(stamps) - 1) / (stamps[-1] - stamps[0])


def toy_dagger(scene, ext, device, mesh=None, pgd_iters=None, overrides=None):
    """Phase 4's `run_dagger` (toy head), on `mesh` when given, for
    `pgd_iters` PGD iterations when given (else phase 4's 7), with
    `overrides` of its `AttackConfig` when given, with the
    launch counts set to 0 just before and read just after: (result, each
    logged line with its host time, launches). `run_dagger` logs one
    "Iteration:" line per PGD iteration, after the loss has come back to
    the host."""
    import dataclasses

    import torch

    from gsattack_torch.attack import run_dagger
    from gsattack_torch.models import ToyDetector

    det = ToyDetector(num_classes=8, seed=0, device=device)
    lines = []
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        zero_launch_counts()
        cfg = main_attack_config(out_dir)
        if pgd_iters is not None:  # the per-batch budget takes one iteration
            cfg = dataclasses.replace(cfg, max_iters=pgd_iters + 1)
        cfg = dataclasses.replace(cfg, **(overrides or {}))
        res = run_dagger(scene, [ext], det, cfg, mesh=mesh,
                         log=lambda line: lines.append((time.perf_counter(), line)))
        torch.cuda.synchronize()
        launches = launch_counts()
    return res, lines, launches


def phase_main_path(scene, cams, ext, pairs, device):
    """Phase 4: run_dagger with the counters read around it, then the
    end-to-end rates on the same 4-view batch."""
    import numpy as np
    import torch

    from gsattack_torch.attack import render_views
    from gsattack_torch.models import ToyDetector

    det = ToyDetector(num_classes=8, seed=0, device=device)
    t0 = time.perf_counter()
    with deterministic_cudnn():
        res, lines, launches = toy_dagger(scene, ext, device)
    wall = time.perf_counter() - t0
    for _, line in lines:
        log("  " + line)
    losses = np.asarray(res.losses)
    log(f"phase 4  run_dagger: {len(losses)} PGD iterations in {wall:.2f} s (with set-up, "
        f"benign and eval renders, cuDNN deterministic); launches fwd {launches['fwd']}, bwd "
        f"{launches['bwd']}, gather_sum {launches['gather_sum']}, gather {launches['gather']}")
    if not (launches["fwd"] > 0 and launches["bwd"] > 0 and launches["gather_sum"] > 0):
        raise AssertionError(f"main path did not launch the blend's kernels: {launches}")
    if len(losses) == 0 or not np.isfinite(losses).all():
        raise AssertionError(f"losses not finite: {losses}")
    # Host wall time of run_dagger's own loop (loss render, backward, step,
    # eval render, its copy to the host and the detector's decision), from
    # the first iteration's line to the last: the first iteration, with its
    # warm-up, is left out.
    stamps = [t for t, line in lines if line.startswith("Iteration:")]
    if len(stamps) < 3:
        raise AssertionError(f"run_dagger ran {len(stamps)} iterations, too few to time")
    pgd_it_s = iteration_rate(stamps)
    for k, v in res.scene.params().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"final scene {k} not finite")
    if not torch.equal(res.scene.xyz, scene.xyz):
        raise AssertionError("a colour attack moved the positions")
    moved = (res.scene.f_dc - scene.f_dc).reshape(scene.num_points, -1).norm(dim=1)
    if not 0 < float(moved.max()) <= main_attack_config("").epsilon * (1 + 1e-5):
        raise AssertionError(f"f_dc delta outside the l2 ball: {float(moved.max())}")

    # Render rates, after a warm-up.
    bg = torch.zeros(3, device=device)
    boxes = np.tile(np.array([[200, 200, 600, 600]], np.float32), (4, 1))
    def fwd_bwd(with_objects):
        def run():
            leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
            imgs = render_views(scene.with_params(leaves), cams, bg, pairs, MAX_CHUNKS, CHUNK,
                                with_objects=with_objects)
            torch.autograd.grad((imgs ** 2).mean(), list(leaves.values()), allow_unused=True)
        return run

    iters = 5
    rgb_ms = cuda_ms(fwd_bwd(False), reps=iters)
    obj_ms = cuda_ms(fwd_bwd(True), reps=iters)
    mpix = cams.num_views * cams.width * cams.height / 1e6
    rates = {
        "pgd_it_s": pgd_it_s,
        "fwd_bwd_mpix_s_rgb": mpix / (rgb_ms / 1e3),
        "fwd_bwd_mpix_s_objects": mpix / (obj_ms / 1e3),
        "fwd_bwd_ms_rgb": rgb_ms, "fwd_bwd_ms_objects": obj_ms,
    }
    log(f"  PGD {rates['pgd_it_s']:.3f} it/s (run_dagger, 4 views); fwd+bwd "
        f"{rates['fwd_bwd_mpix_s_rgb']:.2f} Mpix/s RGB, "
        f"{rates['fwd_bwd_mpix_s_objects']:.2f} Mpix/s with objects")
    # After the rates: the profiler's tracing slows what runs under it.
    profile = profile_pgd(make_pgd_iter(scene, cams, det, pairs, bg, boxes))
    stages = stage_breakdown(scene, cams, det, pairs, bg, boxes)
    return {"launches": launches, "losses": losses.tolist(), "rates": rates,
            "iterations": len(losses), "pairs_per_gaussian": pairs, "profile": profile,
            "stages_ms": stages, "f_dc": res.scene.f_dc.cpu()}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (and its autotuner
    off): with its defaults, the toy head's stride-2 convolutions take a
    backward-data algorithm whose sums change from run to run."""
    import torch

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def stage_repeats(scene, cams, pairs, bg, boxes, device) -> dict:
    """One loss-and-gradient of phase 4's attack twice: whether each stage
    (the render, the toy head's loss, its image gradient, the f_dc
    gradient through the blend) came out equal (`torch.equal`), and the
    largest difference."""
    import torch

    from gsattack_torch.attack import render_views
    from gsattack_torch.models import ToyDetector

    from torch.profiler import ProfilerActivity, profile

    det = ToyDetector(num_classes=8, seed=0, device=device)
    got = []
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        imgs = render_views(scene.with_params(leaves), cams, bg, pairs, MAX_CHUNKS, CHUNK)
        im = imgs.detach().requires_grad_(True)
        loss = det.loss(im, 2, boxes)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (d_img,) = torch.autograd.grad(loss, [im])
            torch.cuda.synchronize()
        (d_f_dc,) = torch.autograd.grad(imgs, [leaves["f_dc"]], d_img)
        got.append({"render": imgs.detach(), "loss": loss.detach(), "d_image": d_img,
                    "d_f_dc": d_f_dc})
    out = {k: {"equal": torch.equal(got[0][k], got[1][k]),
               "max_abs": float((got[0][k] - got[1][k]).abs().max())} for k in got[0]}
    # The cuDNN kernels of the head's backward (its convolutions' image
    # gradients), by name.
    out["cudnn_kernels"] = sorted({a.key[:70] for a in prof.key_averages()
                                   if "cudnn" in a.key or "dgrad" in a.key.lower()})
    return out


def phase_reproducible(scene, cams, ext, pairs, shapes: dict, main: dict, device) -> dict:
    """Phase 4b: the backward (blend_bwd, then gather_sum_rows) twice on
    phase 3's inputs, equal to phase 3's call (`torch.equal`); one
    loss-and-gradient of phase 4's attack twice, stage by stage, with
    cuDNN's defaults and with its deterministic algorithms (which stage
    varies); then phase 4's `run_dagger` again, its losses and final f_dc
    equal to phase 4's (`torch.equal`) after all its PGD iterations."""
    import numpy as np
    import torch

    again = [shapes["rerun"]() for _ in range(2)]
    bwd_equal = all(torch.equal(a, b) for run in again for a, b in zip(run, shapes["grads"]))
    bg = torch.zeros(3, device=device)
    boxes = np.tile(np.array([[200, 200, 600, 600]], np.float32), (4, 1))
    stages = {"cudnn_default": stage_repeats(scene, cams, pairs, bg, boxes, device)}
    with deterministic_cudnn():
        stages["cudnn_deterministic"] = stage_repeats(scene, cams, pairs, bg, boxes, device)
        res = toy_dagger(scene, ext, device)[0]
    losses_equal = list(res.losses) == list(main["losses"])
    f_dc = res.scene.f_dc.cpu()
    f_dc_equal = torch.equal(f_dc, main["f_dc"])
    out = {"backward_equal": bwd_equal, "stages": stages, "losses_equal": losses_equal,
           "f_dc_equal": f_dc_equal, "iterations": len(res.losses),
           "f_dc_max_abs": float((f_dc - main["f_dc"]).abs().max())}
    log(f"phase 4b reproducibility: the backward three times on phase 3's inputs "
        f"{'equal' if bwd_equal else 'NOT equal'}; one loss-and-gradient twice, stage by stage "
        f"(equal?): " + "; ".join(
            f"{mode} " + ", ".join(f"{k} {v['equal']} ({v['max_abs']:.2e})" for k, v in st.items()
                                   if k != "cudnn_kernels")
            + f", the head's cuDNN backward kernels {st['cudnn_kernels']}"
            for mode, st in stages.items())
        + f"; run_dagger again ({len(res.losses)} PGD iterations): losses equal {losses_equal}, "
        f"f_dc equal {f_dc_equal} (max abs {out['f_dc_max_abs']:.2e})")
    if not (bwd_equal and losses_equal and f_dc_equal):
        raise AssertionError(f"phase 4b: not reproducible: {out}")
    return out


def detector_heads(name: str, det, images):
    """The head outputs a detector's loss reads: YOLO's Detect maps, the
    Faster R-CNN RPN's objectness and deltas per level, DETR's class
    logits and boxes."""
    import torch

    with torch.no_grad():
        out = det(images)
    if name.startswith("yolo"):
        return list(out[0])
    if name == "detectron2":
        return [t for level in out[1] for t in level]
    return list(out)


# The discrete choices inside each family's loss, by module and function:
# YOLO's task-aligned assignment, Faster R-CNN's top-k selections (the
# proposals per level and overall, the ROI batch), DETR's greedy match.
CHOICES = {"yolo": ("yolo", "task_aligned_assign"), "detectron2": ("frcnn", "_top"),
           "detr": ("detr", "greedy_match")}


@contextlib.contextmanager
def choices(name: str, replay=None):
    """Within the block, the discrete choices of `name`'s loss are recorded
    into the list it yields, or, given `replay` (an earlier block's list),
    taken from it in call order: index outputs as recorded (moved to the
    arguments' device), and a top-k's values read at the recorded
    indices."""
    import importlib

    import torch

    mod_name, fn_name = CHOICES["yolo" if name.startswith("yolo") else name]
    mod = importlib.import_module(f"gsattack_torch.models.{mod_name}")
    real = getattr(mod, fn_name)
    log_ = []

    def wrapped(*args, **kwargs):
        dev = args[0].device
        if replay is None:
            out = real(*args, **kwargs)
            log_.append(out)
            return out
        out = replay[len(log_)]
        log_.append(out)
        if fn_name == "_top":
            idx = out[1].to(dev)
            return torch.gather(args[0], -1, idx), idx
        if isinstance(out, tuple):
            return tuple(t.to(dev) for t in out)
        return out.to(dev)

    setattr(mod, fn_name, wrapped)
    try:
        yield log_
    finally:
        setattr(mod, fn_name, real)


def choices_differing(a: list, b: list) -> int:
    """How many entries of two recordings' index and mask outputs differ."""
    import torch

    n = 0
    for x, y in zip(a, b):
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        for u, v in zip(xs, ys):
            if u.dtype in (torch.bool, torch.int64, torch.int32):
                n += int((u.cpu() != v.cpu()).sum())
    return n


def detector_on_card(name: str, det, imgs, boxes) -> dict:
    """Phase 6a for one detector: loss and image gradient on the card
    (finite, nonzero), their time, and the same module moved to the CPU on
    the same views: the head outputs (max rel, gate `GATE_DETECTOR`), the
    loss with the card's discrete choices replayed (rel, same gate), and,
    reported only, the loss and the count of choices that differ when the
    CPU makes its own (near-ties among the seeded weights' flat scores)."""
    import copy

    import torch

    x = imgs.detach().clone().requires_grad_(True)
    with choices(name) as card_choices:
        loss = det.loss(x, 2, boxes)
    (grad,) = torch.autograd.grad(loss, [x])
    grad_max = float(grad.abs().max())
    if not (math.isfinite(loss.item()) and bool(torch.isfinite(grad).all()) and grad_max > 0):
        raise AssertionError(f"phase 6 {name}: loss {loss.item()}, gradient max {grad_max}")

    def loss_and_grad():
        xx = imgs.detach().clone().requires_grad_(True)
        torch.autograd.grad(det.loss(xx, 2, boxes), [xx])

    ms = cuda_ms(loss_and_grad, reps=3)
    detector_profile = profile_pgd(loss_and_grad, iters=2, top=6,
                                   what="detector loss + image gradient calls")
    heads = detector_heads(name, det, imgs)
    det_cpu = copy.deepcopy(det).to("cpu")
    x_cpu = imgs.detach().cpu()
    heads_cpu = detector_heads(name, det_cpu, x_cpu)
    with torch.no_grad():
        with choices(name, replay=card_choices):
            loss_cpu = det_cpu.loss(x_cpu, 2, boxes).item()
        with choices(name) as cpu_choices:
            loss_free = det_cpu.loss(x_cpu, 2, boxes).item()
    del det_cpu
    head_err = max(max_rel(a.cpu(), b) for a, b in zip(heads, heads_cpu))
    loss_err = abs(loss.item() - loss_cpu) / max(abs(loss_cpu), 1e-12)
    free_err = abs(loss.item() - loss_free) / max(abs(loss_free), 1e-12)
    flips = choices_differing(card_choices, cpu_choices)
    n_params = sum(v.numel() for v in det.state_dict().values())
    log(f"  {name}: {n_params} weights; loss {loss.item():.6g} (CPU with the card's choices "
        f"{loss_cpu:.6g}, rel {loss_err:.2e}; CPU on its own {loss_free:.6g}, rel {free_err:.2e}, "
        f"{flips} choice entries differ); heads max rel {head_err:.2e} over {len(heads)} maps; "
        f"image gradient max |g| {grad_max:.3e}, finite; loss + backward {ms:.2f} ms on the card")
    if head_err > GATE_DETECTOR or loss_err > GATE_DETECTOR:
        raise AssertionError(f"phase 6 {name}: card vs CPU heads {head_err}, loss {loss_err} "
                             f"(gate {GATE_DETECTOR})")
    return {"loss": loss.item(), "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
            "loss_cpu_own_choices": loss_free, "choice_entries_differing": flips,
            "heads_max_rel_err": head_err, "grad_max_abs": grad_max, "loss_bwd_ms": ms,
            "weights": n_params, "loss_bwd_profile": detector_profile}


def detector_attack_config(name: str, pairs: int, out_dir: str):
    """Phase 6's `run_dagger` settings for detector `name` (phase 9c runs
    yolov8's on the mesh)."""
    from gsattack_torch.attack import AttackConfig

    return AttackConfig(
        epsilon=5.0, alpha=0.5, max_iters=DETECTOR_PGD_ITERS + 1, batch_size=4,
        add_cams=4, target=2, attributes=("color",), norm="l2", eval_every=1,
        attack_conf_thresh=0.99, pairs_per_gaussian=pairs, chunk=CHUNK,
        max_chunks=MAX_CHUNKS, output_dir=out_dir, detector_name=name,
    )


def phase_detectors(scene, cams, ext, pairs, device) -> dict:
    """Phase 6: the detector zoo at full width on the main path's scene.
    (a) yolov8 (n, imgsz 640, 80 classes), detectron2 (R50-FPN, 80 classes)
    and detr (R50 + 6 / 6 transformer, 91 classes), each held card against
    CPU (`detector_on_card`); (b) `run_dagger` against each, 4 PGD
    iterations on the colours, with the launch counts read around it, its
    PGD it/s and the loss-and-step iteration's device busy share; (c) the
    other YOLO families (v3, v5s, v11n): loss and backward at imgsz 640,
    finite and nonzero."""
    import numpy as np
    import torch

    from gsattack_torch.attack import render_views, run_dagger
    from gsattack_torch.attack.silhouette import silhouette_bbox
    from gsattack_torch.models import load_detector

    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        imgs = render_views(scene, cams, bg, pairs, MAX_CHUNKS, CHUNK)
    boxes = np.stack([silhouette_bbox(im).cpu().numpy() for im in imgs]).astype(np.float32)
    log(f"phase 6  detectors at full width on {imgs.shape[0]} views of {tuple(imgs.shape[1:])}, "
        f"silhouette boxes {boxes.tolist()}:")
    out = {}
    for name in MAIN_DETECTORS:
        det = load_detector(name, seed=0, device=device)
        row = detector_on_card(name, det, imgs, boxes)
        with tempfile.TemporaryDirectory() as out_dir:
            cfg = detector_attack_config(name, pairs, out_dir)
            lines = []
            zero_launch_counts()
            res = run_dagger(scene, [ext], det, cfg,
                             log=lambda line: lines.append((time.perf_counter(), line)))
            torch.cuda.synchronize()
            launches = launch_counts()
        stamps = [t for t, line in lines if line.startswith("Iteration:")]
        losses = np.asarray(res.losses)
        if not (launches["fwd"] > 0 and launches["bwd"] > 0):
            raise AssertionError(f"phase 6 run_dagger with {name} did not launch both blend "
                                 f"kernels: {launches}")
        if len(losses) != DETECTOR_PGD_ITERS or not np.isfinite(losses).all():
            raise AssertionError(f"phase 6 run_dagger with {name}: losses {losses}")
        row["pgd_losses"] = losses.tolist()
        row["launches"] = launches
        row["pgd_it_s"] = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        log(f"  run_dagger with {name}: {len(losses)} PGD iterations, losses "
            f"{[round(v, 6) for v in losses.tolist()]}; launches fwd {launches['fwd']}, bwd "
            f"{launches['bwd']}; PGD {row['pgd_it_s']:.3f} it/s")
        row["profile"] = profile_pgd(make_pgd_iter(scene, cams, det, pairs, bg, boxes), top=8)
        out[name] = row
        del det, res
        torch.cuda.empty_cache()
    for name in OTHER_YOLOS:
        det = load_detector(name, seed=0, device=device)
        x = imgs.detach().clone().requires_grad_(True)
        loss = det.loss(x, 2, boxes)
        (grad,) = torch.autograd.grad(loss, [x])
        grad_max = float(grad.abs().max())
        log(f"  {name} ({det.variant}, imgsz {det.imgsz}): loss {loss.item():.6g}, image gradient "
            f"max |g| {grad_max:.3e}")
        if not (math.isfinite(loss.item()) and bool(torch.isfinite(grad).all()) and grad_max > 0):
            raise AssertionError(f"phase 6 {name}: loss {loss.item()}, gradient max {grad_max}")
        out[name] = {"variant": det.variant, "loss": loss.item(), "grad_max_abs": grad_max}
        del det
    log("phase 6 summary " + json.dumps(
        {k: {f: v for f, v in row.items() if not f.endswith("profile")} for k, row in out.items()}))
    return out


# Phase 7: 3DGS training and CLOAK. The target is phase 4's scene moved by
# -6 in z, so that the yaw-augmented views orbit it (their centres lie on a
# circle of radius 6 around it: the nerf++ radius, which sets the extent, is
# then nonzero); view 0 is phase 4's view.
TRAIN_SPLATS, TRAIN_SIZE, TRAIN_FOV = 100_000, 800, 1.0
TRAIN_VIEWS, HELD_OUT = 9, 3
TRAIN_POINT_NOISE = 0.02
# configs/config.yaml's schedule scaled to 600 steps: (default, here).
TRAIN_REDUCED = {
    "iterations": (30_000, 600),
    "position_lr_max_steps": (30_000, 600),
    "densify_from_iter": (500, 100),
    "densify_until_iter": (15_000, 500),
    "opacity_reset_interval": (3_000, 300),
    "sh_increase_interval": (1_000, 150),
    "capacity_headroom": (1.5, 1.1),
}
TRAIN_CHECKPOINT_EVERY = 300
LOSS_WINDOW = 50
GATE_TRAIN_LOSS = 1e-5
GATE_DENSIFY = 1e-6
CLOAK_VIEWS = (0, 4)
CLOAK_ITERS = 200
PARITY_SPLATS, PARITY_SIZE, PARITY_EXTENT = 10_000, 256, 3.0


def train_config(extent: float, width: int):
    """`TrainConfig` at configs/config.yaml's values (its defaults), the
    schedule cut as `TRAIN_REDUCED` says, the position learning rate
    scaled by the scene's extent, and the densify threshold in the units
    of the trainer's mean2d gradient: the reference's 2e-4 is per NDC unit
    (its rasterizer scales the screen-space gradient by W / 2), the
    trainer's gradient is per pixel."""
    from gsattack_torch.train import TrainConfig

    return TrainConfig(
        spatial_lr_scale=extent,
        densify_grad_threshold=TrainConfig.densify_grad_threshold * 2.0 / width,
        **{k: here for k, (_, here) in TRAIN_REDUCED.items()},
    )


def loss_fell(losses, window: int = LOSS_WINDOW) -> tuple[bool, float, float]:
    """Whether the mean loss of the last `window` steps is below that of
    the first `window`; and the two means."""
    import numpy as np

    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    return last < first, first, last


def write_colmap_model(root: str, exts, points, colors) -> None:
    """A COLMAP text model under `root/sparse/0`: a PINHOLE camera and an
    image (`view_{i:03d}.png`, not on disk) per view, and the points with
    their colours in [0, 1] as bytes."""
    import numpy as np

    from gsattack_torch.core.transforms import fov2focal
    from gsattack_torch.io import colmap as cm

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    cams, ims = {}, {}
    for i, e in enumerate(exts, 1):
        cams[i] = cm.ColmapCamera(i, "PINHOLE", e.width, e.height, np.array(
            [fov2focal(e.fovx, e.width), fov2focal(e.fovy, e.height), e.width / 2, e.height / 2]))
        ims[i] = cm.ColmapImage(i, cm.rotmat2qvec(e.R.T), e.T, i, f"view_{i - 1:03d}.png",
                                np.zeros((0, 2)), np.zeros(0, int))
    cm.write_intrinsics_text(os.path.join(sparse, "cameras.txt"), cams)
    cm.write_extrinsics_text(os.path.join(sparse, "images.txt"), ims)
    rgb = np.clip(np.round(np.asarray(colors) * 255.0), 0, 255).astype(np.int64)
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        f.writelines(f"{i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g} {c[0]} {c[1]} {c[2]} 0\n"
                     for i, (p, c) in enumerate(zip(np.asarray(points), rgb)))


def cameras_err(got, want) -> float:
    """Largest difference between read-back and written views: rotation,
    translation and FoVs (max abs), sizes (inf when they differ)."""
    import numpy as np

    err = 0.0
    if len(got) != len(want):
        return math.inf
    for a, b in zip(got, want):
        if (a.width, a.height) != (b.width, b.height):
            return math.inf
        err = max(err, float(np.abs(a.R - b.R).max()), float(np.abs(a.T - b.T).max()),
                  abs(a.fovx - b.fovx), abs(a.fovy - b.fovy))
    return err


def training_views(device):
    """Phase 7's target scene (phase 4's, moved), its 9 views and their GT
    renders on the card."""
    import numpy as np
    import torch

    from gsattack_torch.attack import expand_viewpoints
    from gsattack_torch.core.camera import CameraExtrinsics
    from gsattack_torch.render import render

    target = build_scene(TRAIN_SPLATS, seed=0, knn=1e-4, device=device)
    target = target.replace(xyz=target.xyz - torch.tensor([0.0, 0.0, 6.0], device=device))
    base = CameraExtrinsics(np.eye(3), np.array([0.0, 0.0, 6.0]), TRAIN_FOV, TRAIN_FOV,
                            TRAIN_SIZE, TRAIN_SIZE)
    exts = expand_viewpoints([base], TRAIN_VIEWS)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        gts = [render(target, e.build(device=device), bg)["render"] for e in exts]
    return target, exts, gts


def phase_train_parity(device) -> dict:
    """Phase 7a: one training step with the grouping regulariser on, from
    one state, on the card (kernels) and on the CPU (plain): loss (rel),
    every parameter gradient and the mean2d gradient (max rel); then one
    densify/prune pass of the card's state on both, with the same draws."""
    import torch

    from gsattack_torch.render import render
    from gsattack_torch.train import Trainer, TrainConfig, TrainState
    from gsattack_torch.train.densify import N_SPLIT, densify_and_prune

    cpu = torch.device("cpu")
    scene = build_scene(PARITY_SPLATS, seed=1, knn=1e-3, device=device, anisotropic=True)
    target = build_scene(PARITY_SPLATS, seed=2, knn=1e-3, device=device, anisotropic=True)
    ext = base_camera(PARITY_SIZE, PARITY_SIZE)
    cams = {d: ext.build(device=d) for d in (device, cpu)}
    with torch.no_grad():
        gt = render(target, cams[device], torch.zeros(3, device=device))["render"]
    g = torch.Generator().manual_seed(8)
    classifier = (torch.randn((8, 16), generator=g), torch.randn(8, generator=g))
    cfg = TrainConfig(use_reg3d=True)
    card = Trainer(scene, cfg, PARITY_EXTENT, classifier=classifier, device=device)
    host = Trainer(scene.to(cpu), cfg, PARITY_EXTENT, classifier=classifier, device=cpu)
    host.state = card.state.to(cpu)
    cap = card.state.scene.num_points
    idx = torch.randperm(cap, generator=g)[:cfg.reg3d_sample_size]

    out = {}
    for name, tr, d in (("card", card, device), ("cpu", host, cpu)):
        loss, grads, g2d, _ = tr.loss_and_grads(cams[d], gt.to(d), idx)
        out[name] = {"grads": {k: v.cpu() for k, v in grads.items()}, "mean2d": g2d.cpu()}
        out[name]["loss"] = tr.train_step(cams[d], gt.to(d), idx)
    a, b = out["card"], out["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    grad_err = {k: max_rel(a["grads"][k], b["grads"][k]) for k in a["grads"]
                if float(b["grads"][k].abs().max()) > 0}
    grad_err["mean2d"] = max_rel(a["mean2d"], b["mean2d"])
    log(f"phase 7a training step, card against CPU ({PARITY_SPLATS} splats, capacity {cap}, "
        f"{PARITY_SIZE}x{PARITY_SIZE}, 19 ch, reg3d on): loss {a['loss']:.7g} / {b['loss']:.7g} "
        f"(rel {loss_err:.2e}); gradients max rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in grad_err.items()))
    if not (loss_err <= GATE_TRAIN_LOSS and max(grad_err.values()) <= GATE_GRAD
            and all(math.isfinite(v) for v in grad_err.values())):
        raise AssertionError(f"phase 7a step gate: loss {loss_err}, gradients {grad_err}")

    # Densify: the card's state on both sides, a threshold at the lower
    # quartile of the visible points' gradients (so that the children
    # overflow the free slots), the same draws; first the pass alone, then
    # the trainer's (the pass and the capacity growth).
    st = card.state
    hot = st.stats.xyz_gradient_accum / st.stats.denom.clamp(min=1.0)
    thr = float(torch.quantile(hot[st.stats.denom > 0], 0.25))
    noise = torch.randn((N_SPLIT, cap, 3), generator=g)
    kw = dict(max_grad=thr, extent=PARITY_EXTENT, percent_dense=cfg.percent_dense, noise=noise)
    res = {}
    for name, s in (("card", st), ("cpu", st.to(cpu))):
        sc, _, dropped, (mu, nu) = densify_and_prune(s.scene, s.stats, moments=(s.mu, s.nu), **kw)
        res[name] = (TrainState(sc, mu, nu, s.count, s.stats, s.step).to(cpu), dropped)
    (sa, da), (sb, db) = res["card"], res["cpu"]
    alive_equal, val_err = states_differ(sa, sb)
    cfg.densify_grad_threshold = thr
    host.state = st.to(cpu)
    for tr in (card, host):
        tr.maybe_densify(cfg.densify_from_iter, noise=noise)
    grown_equal, grown_err = states_differ(card.state.to(cpu), host.state)
    grown = (card.state.scene.num_points, host.state.scene.num_points)
    log(f"  densify_and_prune of the card's state on both (threshold {thr:.3e}, the lower "
        f"quartile): alive {int(st.scene.alive.sum())} -> {int(sa.scene.alive.sum())} / "
        f"{int(sb.scene.alive.sum())}, alive equal {alive_equal}, dropped {da} / {db}; "
        f"parameters and moments max abs {val_err:.2e}; through Trainer.maybe_densify: "
        f"capacity {cap} -> {grown[0]} / {grown[1]}, states equal {grown_equal}, max abs "
        f"{grown_err:.2e}")
    if not (alive_equal and da == db > 0 and val_err <= GATE_DENSIFY and grown_equal
            and grown[0] == grown[1] > cap and grown_err <= GATE_DENSIFY):
        raise AssertionError(f"phase 7a densify gate: alive equal {alive_equal}, dropped "
                             f"{da} / {db}, max abs {val_err}; grown {grown}, equal "
                             f"{grown_equal}, max abs {grown_err}")
    return {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err, "densify_max_abs_err": val_err,
            "dropped": da, "alive_after": int(sa.scene.alive.sum()), "capacity": [cap, grown[0]],
            "grown_max_abs_err": grown_err}


def states_differ(a, b) -> tuple[bool, float]:
    """Whether two training states' `alive` masks and shapes are equal, and
    the largest difference of their parameters, moments and stats."""
    import torch

    if a.scene.num_points != b.scene.num_points or not torch.equal(a.scene.alive, b.scene.alive):
        return False, math.inf
    pairs = [(a.scene.params()[k], b.scene.params()[k]) for k in a.mu]
    pairs += [(a.mu[k], b.mu[k]) for k in a.mu] + [(a.nu[k], b.nu[k]) for k in a.mu]
    pairs += list(zip(a.stats, b.stats))
    return True, max(float((x - y).abs().max()) for x, y in pairs)


def densify_inputs(trainer, iteration: int) -> dict:
    """What the trainer's next densify pass will see: quantiles of the
    averaged mean2d gradients of the alive, visible points, and how many
    points each rule picks (clone, split, low opacity, and the screen-size
    limit when it is on)."""
    import torch

    cfg, st = trainer.cfg, trainer.state
    g = st.stats.xyz_gradient_accum / st.stats.denom.clamp(min=1.0)
    seen = st.scene.alive & (st.stats.denom > 0)
    q = torch.quantile(g[seen].float().cpu(), torch.tensor([0.5, 0.99, 0.999])).tolist()
    hot = (g >= cfg.densify_grad_threshold) & st.scene.alive
    small = st.scene.scaling.max(dim=-1).values <= cfg.percent_dense * trainer.cameras_extent
    out = {"grad q50": q[0], "q99": q[1], "q99.9": q[2], "clone": int((hot & small).sum()),
           "split": int((hot & ~small).sum()),
           "low opacity": int(((torch.sigmoid(st.scene.opacity_logit[:, 0]) < cfg.min_opacity)
                                & st.scene.alive).sum())}
    if iteration > cfg.opacity_reset_interval:
        out["wider than max_screen_size"] = int(
            ((st.stats.max_radii2d > cfg.max_screen_size) & st.scene.alive).sum())
    return out


def train_stage_breakdown(trainer, cam, gt, reps: int = 3) -> dict:
    """Host wall time of each stage of one training step on the trainer's
    state, the card synchronised around every stage, mean over `reps`
    steps after a warm-up (the trainer's state is left as it was)."""
    import torch

    from gsattack_torch.ops.project import project
    from gsattack_torch.ops.raster import bin_gaussians, rasterize
    from gsattack_torch.train.densify import add_densification_stats
    from gsattack_torch.train.trainer import adam_update
    from gsattack_torch.utils.losses import dssim_l1_loss

    cfg, st = trainer.cfg, trainer.state
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    for r in range(reps + 1):
        if r == 1:
            ms.clear()
        leaves = {k: v.detach().requires_grad_(True) for k, v in st.scene.params().items()}
        offset = torch.zeros((st.scene.num_points, 2), device=trainer.device, requires_grad=True)
        sc = st.scene.with_params(leaves)
        proj = timed("project", lambda: project(sc, cam))
        proj = proj._replace(mean2d=proj.mean2d + offset)
        timed("(bin alone, inside the next)", lambda: bin_gaussians(
            proj.mean2d, proj.depth, proj.radius_tight, cam.width, cam.height,
            cfg.pairs_per_gaussian, conic=proj.conic, opacity=proj.opacity))
        out = timed("rasterize: bin + blend forward", lambda: rasterize(
            proj, cam.width, cam.height, trainer.background, cfg.pairs_per_gaussian,
            max_chunks=cfg.max_chunks))
        loss = timed("loss (L1 + D-SSIM)", lambda: dssim_l1_loss(out["render"], gt,
                                                                 cfg.lambda_dssim))
        got = timed("backward (loss, blend, project)", lambda: torch.autograd.grad(
            loss, [*leaves.values(), offset], allow_unused=True))
        grads = {k: torch.zeros_like(leaves[k]) if v is None else v for k, v in zip(leaves, got)}
        timed("adam", lambda: adam_update(st.scene.params(), grads, st.mu, st.nu, st.count,
                                          trainer.lr_tree(st.step)))
        timed("densify stats", lambda: add_densification_stats(st.stats, got[-1],
                                                               proj.radius))
    ms = {k: v / reps for k, v in ms.items()}
    total = sum(v for k, v in ms.items() if not k.startswith("("))
    log(f"  stages of one training step ({st.scene.num_points} slots, {total:.2f} ms, "
        "synchronised around each):")
    for k, v in ms.items():
        log(f"    {v:8.3f} ms  {k}")
    return ms


def train_init(device):
    """Phase 7b's views and initial scene: the target's 9 views and GT
    renders, its points moved by noise written with the views as a COLMAP
    text model and read back (`info`), and the 3-NN scene of those points.
    Returns (exts, gts, info, init, the model's write-and-read seconds)."""
    import torch

    from gsattack_torch.core.scene import scene_from_points
    from gsattack_torch.core.sh import sh_to_rgb_dc
    from gsattack_torch.io import load_scene_info

    target, exts, gts = training_views(device)
    g = torch.Generator().manual_seed(11)
    pts = (target.xyz.cpu() + torch.randn(target.xyz.shape, generator=g) * TRAIN_POINT_NOISE)
    cols = sh_to_rgb_dc(target.f_dc[:, 0].cpu()).clamp(0, 1)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_colmap_model(root, exts, pts.numpy(), cols.numpy())
        info = load_scene_info(root, shuffle=False)
        io_s = time.perf_counter() - t0
    init = scene_from_points(info.points, info.colors, max_sh_degree=3,
                             generator=torch.Generator().manual_seed(12), device=device)
    return exts, gts, info, init, io_s


def trainer_slot_table(init, ext, device):
    """The slot table of phase 11c's first training step: `init` padded to
    the trainer's capacity (`TRAIN_REDUCED`'s headroom), projected on
    `ext`'s view and binned at the caps `auto_caps` gives that view
    unpadded, as phase 11c sizes them. Returns the table (capacity,
    pairs_per_gaussian) int32 and rows (pairs, 6 + CH) for
    `gather_sum_rows` to sum over it: the shape the blend backward writes,
    with random values made from a seed (they do not change the sum's
    work)."""
    import torch

    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import auto_caps, bin_views

    cam = ext.build(device=device)
    init = init.to(device)
    with torch.no_grad():
        pairs, rect, budget, compact, (ts, hb) = auto_caps(project(init, cam), cam.width,
                                                           cam.height)
        capacity = int(init.num_points * TRAIN_REDUCED["capacity_headroom"][1])
        proj = stack_projections([project(init.pad_to(capacity), cam)])
        bins = bin_views(proj, cam.width, cam.height, pairs, rect, tier_split=ts,
                         heavy_budget=hb, pairs_budget=budget, compact_budget=compact)
    w = 6 + proj.color.shape[-1] + proj.obj.shape[-1]
    g = torch.Generator(device=device).manual_seed(13)
    rows = torch.randn((bins.gauss_idx.shape[0], w), generator=g, device=device)
    return bins.slot_table, rows


def wide_sum(table, rows) -> dict:
    """`gather_sum_rows` of `rows` over `table`: equal to its plain
    version, its time and byte bound, and how the named slots fall over
    the table's rows."""
    import torch

    from gsattack_torch.ops.gather_sum import gather_sum_rows, gather_sum_rows_plain

    w = rows.shape[1]
    per_row = (table >= 0).sum(1)
    with torch.no_grad():
        equal = torch.equal(gather_sum_rows(rows, table), gather_sum_rows_plain(rows, table))
        ms = cuda_ms(lambda: gather_sum_rows(rows, table), reps=10)
    named = int(per_row.sum())
    bound_ms, by = bound(sum_bytes(table, w), named * w)
    return {"table": list(table.shape), "w": w, "named": named,
            "rows_naming_any": int((per_row > 0).sum()), "most_in_a_row": int(per_row.max()),
            "rows_naming_over_512": int((per_row > 512).sum()), "equal": equal, "ms": ms,
            "bound_ms": bound_ms, "bound_by": by}


def phase_train(device) -> dict:
    """Phase 7b: COLMAP model out and back, the 3-NN initial scene, then
    `Trainer.fit` at full width with checkpoints; gates on the loss, the
    held-out PSNR, densify, capacity growth, the SH degree, the launches
    and a checkpoint restore."""
    import numpy as np
    import torch

    from gsattack_torch.io.checkpoint import restore_checkpoint
    from gsattack_torch.ops.knn import mean_knn_dist2
    from gsattack_torch.render import render
    from gsattack_torch.train import Trainer
    from gsattack_torch.utils.losses import psnr

    exts, gts, info, init, io_s = train_init(device)
    cam_err = cameras_err(info.train_cameras, exts)
    extent = info.nerf_normalization["radius"]
    log(f"phase 7b COLMAP text model of {len(exts)} views and {len(info.points)} points written "
        f"and read back in {io_s:.2f} s: cameras max abs err {cam_err:.2e}; nerf++ radius "
        f"{extent:.4f}")
    if not cam_err <= 1e-6:
        raise AssertionError(f"phase 7b cameras read back differ by {cam_err}")

    knn_in = torch.as_tensor(info.points, device=device)
    knn_ms = cuda_ms(lambda: mean_knn_dist2(knn_in), reps=2)
    train_idx = [i for i in range(len(exts)) if i != HELD_OUT]
    cams = [exts[i].build(device=device) for i in train_idx]
    train_gts = [gts[i] for i in train_idx]
    held_cam, held_gt = exts[HELD_OUT].build(device=device), gts[HELD_OUT]
    cfg = train_config(extent, TRAIN_SIZE)
    trainer = Trainer(init, cfg, cameras_extent=extent, device=device)

    def held_psnr():
        with torch.no_grad():
            img = render(trainer.state.scene, held_cam, trainer.background,
                         pairs_per_gaussian=cfg.pairs_per_gaussian,
                         max_chunks=cfg.max_chunks)["render"]
        return float(psnr(img, held_gt))

    psnr_before = held_psnr()
    # Each densify pass: (step, ms, (alive, capacity) before, after, its inputs).
    events = []
    densify = trainer.maybe_densify

    def timed_densify(iteration, *args, **kw):
        if not (cfg.densify_from_iter <= iteration <= cfg.densify_until_iter
                and iteration % cfg.densification_interval == 0):
            return densify(iteration, *args, **kw)
        before = (int(trainer.state.scene.alive.sum()), trainer.state.scene.num_points)
        why = densify_inputs(trainer, iteration)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        densify(iteration, *args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        events.append((iteration, ms, before,
                       (int(trainer.state.scene.alive.sum()), trainer.state.scene.num_points),
                       why))

    trainer.maybe_densify = timed_densify
    log(f"  {len(init.xyz)} points -> initial scene by the 3-NN op on the card "
        f"({knn_ms:.2f} ms); training {cfg.iterations} steps on {len(cams)} views, "
        f"held-out view {HELD_OUT} (PSNR {psnr_before:.3f} dB before); capacity "
        f"{trainer.state.scene.num_points}")
    stamps = []
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as ck:
        log_cb = lambda i, l: stamps.append((time.perf_counter(), i, l))  # noqa: E731
        trainer.fit(cams, train_gts, iterations=TRAIN_CHECKPOINT_EVERY, log=log_cb,
                    checkpoint_dir=ck, checkpoint_every=TRAIN_CHECKPOINT_EVERY)
        snapshot = trainer.state.to("cpu")
        trainer.fit(cams, train_gts, iterations=cfg.iterations, log=log_cb,
                    checkpoint_dir=ck, checkpoint_every=TRAIN_CHECKPOINT_EVERY)
        torch.cuda.synchronize()
        launches = launch_counts()
        restored = {s: restore_checkpoint(os.path.join(ck, f"step_{s}"), target=snapshot)
                    for s in (TRAIN_CHECKPOINT_EVERY, cfg.iterations)}
    final = trainer.state
    restore_equal = all(
        want.keys() == got.keys() and all(
            torch.equal(want[k], got[k]) if isinstance(want[k], torch.Tensor)
            else want[k] == got[k] for k in want)
        for want, got in ((snapshot.state_dict(), restored[TRAIN_CHECKPOINT_EVERY].state_dict()),
                          (final.to("cpu").state_dict(), restored[cfg.iterations].state_dict())))
    losses = [l for _, _, l in stamps]
    its = [i for _, i, _ in stamps]
    t_by_it = {i: t for t, i, _ in stamps}
    train_it_s = (cfg.iterations - 2) / (t_by_it[cfg.iterations] - t_by_it[2])
    psnr_after = held_psnr()
    fell, first, last = loss_fell(losses)
    alive0, alive1 = TRAIN_SPLATS, int(final.scene.alive.sum())
    cap0 = int(TRAIN_SPLATS * cfg.capacity_headroom)
    trunc = int(trainer.max_truncated_pairs)
    for it, ms, before, after, why in events:
        log(f"    densify at step {it}: {ms:.2f} ms, alive {before[0]} -> {after[0]}, "
            f"capacity {before[1]} -> {after[1]}; " + ", ".join(
                f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}" for k, v in why.items()))
    log(f"  fit: {len(losses)} steps, loss first {LOSS_WINDOW} mean {first:.5f}, last "
        f"{LOSS_WINDOW} mean {last:.5f}; held-out PSNR {psnr_before:.3f} -> {psnr_after:.3f} dB; "
        f"alive {alive0} -> {alive1}, capacity {cap0} -> {final.scene.num_points}; SH degree "
        f"{final.scene.active_sh_degree}; launches fwd {launches['fwd']}, bwd {launches['bwd']}; "
        f"largest num_truncated_pairs of a step {trunc}; checkpoints at steps "
        f"{TRAIN_CHECKPOINT_EVERY} and {cfg.iterations} restored equal: {restore_equal}")
    log(f"  train {train_it_s:.3f} it/s over steps 2-{cfg.iterations} (host wall time between "
        "fit's log callbacks, densify, checkpoints and resume included)")
    checks = {
        "losses finite": bool(np.isfinite(losses).all()) and its == list(
            range(1, cfg.iterations + 1)),
        "loss fell": fell,
        "held-out PSNR rose": psnr_after > psnr_before,
        "densify changed the alive count": any(b[0] != a[0] for _, _, b, a, _ in events),
        "SH degree 3": final.scene.active_sh_degree == 3,
        "launches": fewest_blend_launches(launches) >= cfg.iterations,
        "checkpoint restored equal": restore_equal,
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 7b gates failed: {[k for k, v in checks.items() if not v]}")
    gt_view = train_gts[0]
    profile = profile_pgd(lambda: trainer.train_step(cams[0], gt_view), iters=10, top=10,
                          what="training steps")
    stages = train_stage_breakdown(trainer, cams[0], gt_view)
    return {"init": init, "cams": cams, "gts": train_gts, "cfg": cfg, "extent": extent,
            "exts": [exts[i] for i in train_idx],
            "summary": {
                "train_it_s": train_it_s, "launches": launches, "knn_ms": knn_ms,
                "densify_events": events,
                "psnr_before": psnr_before, "psnr_after": psnr_after,
                "loss_first_mean": first, "loss_last_mean": last, "alive": [alive0, alive1],
                "capacity": [cap0, final.scene.num_points], "max_truncated_pairs": trunc,
                "busy_share": profile.get("busy_share"), "stages_ms": stages}}


def phase_cloak(trained: dict, device) -> dict:
    """Phase 7c: CLOAK against yolov8n@640 (seeded weights): 2 of the 8
    training views poisoned with `CloakConfig`'s defaults, then 200 steps of
    retraining from phase 7b's initial scene on 7b's scaled schedule."""
    import copy

    import numpy as np
    import torch

    from gsattack_torch.attack.cloak import CloakConfig, run_cloak
    from gsattack_torch.attack.silhouette import silhouette_bbox
    from gsattack_torch.models import load_detector

    det = load_detector("yolov8", seed=0, device=device)
    ccfg = CloakConfig(target=2, poison_view_indices=CLOAK_VIEWS)
    lines = []
    zero_launch_counts()
    scene, poisoned = run_cloak(
        trained["init"], trained["cams"], trained["gts"], det, ccfg, train_cfg=trained["cfg"],
        iterations=CLOAK_ITERS, cameras_extent=trained["extent"],
        log=lambda line: lines.append((time.perf_counter(), line)), device=device,
    )
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = launch_counts()
    stamps = [t for t, _ in lines]
    poison_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    retrain_it_s = CLOAK_ITERS / (t_end - stamps[-1])
    # The targeted loss of each poisoned view against its clean view's, with
    # the clean view's discrete choices (the task-aligned assignment, made
    # on the card) replayed on a float64 copy on the CPU: the seeded head's
    # scores are flat, so the assignment sits among near-ties whose flips
    # move the loss by more than the perturbation does (ROADMAP Queue 3),
    # and the change is a few float32 roundings of the loss. The free loss
    # on the card and the first-order change <grad at the clean view,
    # poisoned - clean> are reported.
    det64 = copy.deepcopy(det).to("cpu").double()
    rows = []
    for vi, adv in zip(CLOAK_VIEWS, poisoned):
        clean = trained["gts"][vi]
        box = silhouette_bbox(clean).cpu().numpy().astype(np.float32)[None]
        x = clean.detach().clone().requires_grad_(True)
        with choices("yolov8") as rec:
            loss = det.loss(x[None], ccfg.target, box)
        (g,) = torch.autograd.grad(loss, [x])
        with torch.no_grad():
            pinned = []
            for img in (clean, adv):
                with choices("yolov8", replay=rec):
                    pinned.append(det64.loss(img[None].cpu().double(), ccfg.target, box).item())
            l_free = det.loss(adv[None], ccfg.target, box).item()
        rows.append({"view": vi, "linf": float((adv - clean).abs().max()),
                     "min": float(adv.min()), "max": float(adv.max()),
                     "loss_clean": pinned[0], "loss_poisoned": pinned[1],
                     "loss_clean_card": loss.item(), "loss_poisoned_own_choices_card": l_free,
                     "first_order": float((g * (adv - clean)).sum())})
    del det64
    for line in lines:
        log("  " + line[1])
    log(f"phase 7c CLOAK against yolov8n@{det.imgsz}: poisoned views "
        + "; ".join(f"{r['view']}: linf {r['linf']:.5f} (eps {ccfg.epsilon:.5f}), range "
                    f"[{r['min']:.3f}, {r['max']:.3f}], targeted loss {r['loss_clean']:.10g} -> "
                    f"{r['loss_poisoned']:.10g} with the clean view's choices (float64, CPU; "
                    f"on the card {r['loss_clean_card']:.8g} -> "
                    f"{r['loss_poisoned_own_choices_card']:.8g} with its own choices; "
                    f"first-order change {r['first_order']:.3e})" for r in rows)
        + f"; poison {', '.join(f'{s:.2f}' for s in poison_s)} s per view ({ccfg.steps} steps); "
        f"retraining {CLOAK_ITERS} steps at {retrain_it_s:.3f} it/s (trainer set-up included); "
        f"launches fwd {launches['fwd']}, bwd {launches['bwd']}")
    finite =all(bool(torch.isfinite(v).all()) for v in scene.params().values())
    bad = [r["view"] for r in rows
           if not (0 < r["linf"] <= ccfg.epsilon + 1e-6 and r["min"] >= 0 and r["max"] <= 1
                   and r["loss_poisoned"] < r["loss_clean"])]
    if bad or not finite or fewest_blend_launches(launches) < CLOAK_ITERS:
        raise AssertionError(f"phase 7c gates failed: views {bad}, scene finite {finite}, "
                             f"launches {launches}")
    return {"poison_s_per_view": poison_s, "retrain_it_s": retrain_it_s, "launches": launches,
            "views": rows}


# Phase 8: the command line on the card. Phase 7's target and 9 views go
# out as a COLMAP text model with GT PNGs; `gsattack_torch.cli.main` then
# trains, attacks, evaluates and edits through the files, each command in
# this process with the blend's launch counters set to 0 before it.
CLI_TRAIN_ITERS = 300
# configs/config.yaml's schedule cut to CLI_TRAIN_ITERS steps: phase 7b's
# cuts (TRAIN_REDUCED) halved with the step count, the threshold in pixel
# units as `train_config` converts it; `sh_increase_interval` and
# `capacity_headroom` are not in configs/config.yaml, and `cmd_train`
# reads them when given. The opacity reset keeps its 3,000 steps, so none
# falls in the run: halved to 150, it came 50 steps before the densify
# pass at 200, which (with the screen-size limit, on after the first
# reset) pruned the scene to 3,808 dark splats whose renders have no
# silhouette.
CLI_TRAIN_REDUCED = {
    "position_lr_max_steps": (30_000, 300),
    "densify_from_iter": (500, 50),
    "densify_until_iter": (15_000, 250),
    "sh_increase_interval": (1_000, 75),
    "capacity_headroom": (1.5, 1.1),
    "densify_grad_threshold": (2e-4, 2e-4 * 2.0 / TRAIN_SIZE),
}
CLI_BACKGROUND_SPLATS = 100_000
CLI_ATTACK_ITERS = 5
CLI_DETECTOR = ["scene.detector_name=yolov8", "scene.detector_num_classes=80",
                "scene.detector_imgsz=640"]


def yaml_value(x) -> str:
    """A number as an override value that YAML 1.1 reads back as the same
    number: a float needs a '.' in its mantissa (`5e-07` is a string)."""
    if isinstance(x, float):
        mant, _, exp = repr(x).partition("e")
        return (mant if "." in mant else mant + ".0") + (f"e{exp}" if exp else "")
    return str(x)


class StdoutLines:
    """A context that passes stdout through and keeps each line printed,
    with the time it was completed."""

    def __init__(self):
        self.lines, self._buf, self._out = [], "", None

    def write(self, s: str) -> int:
        self._out.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self) -> None:
        self._out.flush()

    def __enter__(self):
        self._out, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out


def run_cli(argv: list, launches: dict, name: str, device: bool = True
            ) -> tuple[int, float, list]:
    """`gsattack_torch.cli.main(argv)`, with `--device cuda` for a command
    that builds tensors (`device`), and with the blend's
    launch counters set to 0 just before and read just after (into
    `launches[name]`). Returns (rc, wall s, stdout lines with times)."""
    import torch

    from gsattack_torch import cli

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with StdoutLines() as out:
        rc = cli.main([*argv, "--device", "cuda"] if device else argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    launches[name] = {k: launches.get(name, {}).get(k, 0) + v for k, v in got.items()}
    log(f"  cli {argv[0]}: rc {rc} in {wall:.2f} s; launches fwd {got['fwd']}, "
        f"bwd {got['bwd']}")
    return rc, wall, out.lines


@contextlib.contextmanager
def render_log(path: str):
    """A file handler on the `render` logger, as a render-eval run's
    capture."""
    import logging

    rlog = logging.getLogger("render")
    rlog.setLevel(logging.INFO)
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    rlog.addHandler(fh)
    try:
        yield
    finally:
        rlog.removeHandler(fh)
        fh.close()


def phase_cli(device) -> dict:
    """Phase 8: the CLI on the card at full width, through files: (a) the
    COLMAP model with GT PNGs, read back equal; (b) `train`; (c) `attack`
    in mode C against yolov8n@640 over a seeded background; (d)
    `render-eval` on the trained and on the attacked scene; (e) `asr` and
    `coco-ap`; (f) `recolor`, `combine`, `grouping-render` and the convex
    hull on the trained splats."""
    import importlib.util

    import numpy as np
    import torch

    import gsattack_torch.attack as attack_mod
    from gsattack_torch.attack import expand_viewpoints, render_views, silhouette_bboxes
    from gsattack_torch.core.camera import stack_cameras
    from gsattack_torch.core.sh import sh_to_rgb_dc
    from gsattack_torch.evals import load_preds
    from gsattack_torch.io import load_scene_info, load_scene_ply, save_scene_ply
    from gsattack_torch.io.png import read_png, to_uint8, write_png
    from gsattack_torch.ops.hull import points_inside_convex_hull

    t_phase = time.perf_counter()
    launches, summary = {}, {}
    target, exts, gts = training_views(device)
    g = torch.Generator().manual_seed(11)
    pts = target.xyz.cpu() + torch.randn(target.xyz.shape, generator=g) * TRAIN_POINT_NOISE
    cols = sh_to_rgb_dc(target.f_dc[:, 0].cpu()).clamp(0, 1)
    configs = os.path.join(ROOT, "configs")
    with tempfile.TemporaryDirectory() as work:
        # 8a: the COLMAP model, its GT frames written by io/png.py.
        src = os.path.join(work, "scene")
        write_colmap_model(src, exts, pts.numpy(), cols.numpy())
        frames = [to_uint8(gt) for gt in gts]
        for i, fr in enumerate(frames):
            write_png(os.path.join(src, "images", f"view_{i:03d}.png"), fr)
        info = load_scene_info(src, shuffle=False)
        read_back = all(c.image is not None and np.array_equal(
            c.image, fr.astype(np.float32) / 255.0) for c, fr in zip(info.train_cameras, frames))
        log(f"phase 8a COLMAP model of {len(exts)} views with {TRAIN_SIZE}x{TRAIN_SIZE} GT PNGs "
            f"and {len(pts)} points; frames read back equal: {read_back}")
        if not (read_back and len(info.train_cameras) == len(exts)):
            raise AssertionError("phase 8a: the GT frames did not read back equal")

        # 8b: train.
        model = os.path.join(work, "model")
        common = [f"--config-dir={configs}", f"scene.source_path={src}",
                  f"scene.model_path={model}", "scene.synthetic=false", "scene.cam_indices=[]",
                  "sh_degree=3"]
        cuts = [f"{k}={yaml_value(here)}" for k, (_, here) in CLI_TRAIN_REDUCED.items()]
        rc, wall, lines = run_cli(["train", "--iterations", str(CLI_TRAIN_ITERS), *common, *cuts],
                                  launches, "train")
        ply = os.path.join(model, "point_cloud", f"iteration_{CLI_TRAIN_ITERS}",
                           "point_cloud.ply")
        trained = load_scene_ply(ply, device=device) if os.path.exists(ply) else None
        summary["train"] = {"rc": rc, "wall_s": wall, "it_s": CLI_TRAIN_ITERS / wall,
                            "splats": trained and trained.num_points,
                            "loss_lines": [line for _, line in lines if line.startswith("iter")]}
        log(f"  train {summary['train']['it_s']:.3f} it/s over the command's wall time "
            f"({CLI_TRAIN_ITERS} steps, set-up and the PLY included); {summary['train']}")
        if not (rc == 0 and trained is not None and all(
                bool(torch.isfinite(v).all()) for v in trained.params().values())
                and fewest_blend_launches(launches["train"]) >= CLI_TRAIN_ITERS):
            raise AssertionError(f"phase 8b gates failed: {summary['train']}, {launches}")

        # 8c: attack, mode C: the trained scene attacked over a background.
        bg_ply = os.path.join(work, "background.ply")
        save_scene_ply(build_scene(CLI_BACKGROUND_SPLATS, seed=1, knn=1e-4, device=device),
                       bg_ply)
        kept = {}
        run_dagger = attack_mod.run_dagger

        def keep_result(scene, *a, **kw):
            kept["scene"], kept["frozen"] = scene, kw.get("frozen_scene")
            kept["res"] = run_dagger(scene, *a, **kw)
            return kept["res"]

        attack_mod.run_dagger = keep_result
        try:
            rc, wall, lines = run_cli(
                ["attack", *common, "combine_splats=true", "no_groups=true",
                 f"scene.combine_splats_paths=[{ply}, {bg_ply}]", *CLI_DETECTOR,
                 "scene.target=car", "scene.cam_indices=[0]", "add_cams=4", "batch_mode=true",
                 "batch_size=4",
                 f"max_iters={CLI_ATTACK_ITERS}", "eval_every=1",
                 f"splat_asset_path={work}"], launches, "attack")
        finally:
            attack_mod.run_dagger = run_dagger
        res = kept["res"]
        stamps = [t for t, line in lines if line.startswith("Iteration:")]
        boxes = silhouette_bboxes(render_views(
            kept["scene"], stack_cameras([v.build(device=device) for v in expand_viewpoints(
                info.train_cameras[:1], 4)]), torch.zeros(3, device=device)).detach())
        trunc = [line for _, line in lines if "truncated" in line]
        combined = kept["scene"].num_points + kept["frozen"].num_points
        summary["attack"] = {
            "rc": rc, "wall_s": wall, "losses": res.losses, "success": res.success,
            "pgd_it_s": (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else None,
            "splats": [kept["scene"].num_points, kept["frozen"].num_points],
            "gt_boxes": boxes.tolist(), "truncated": trunc}
        log(f"  attack: {summary['attack']}")
        if not (rc in (0, 1) and 0 < len(res.losses) <= CLI_ATTACK_ITERS - 1
                and np.isfinite(res.losses).all() and (res.success or len(res.losses)
                                                         == CLI_ATTACK_ITERS - 1)
                and combined == trained.num_points + CLI_BACKGROUND_SPLATS
                and bool((boxes[:, 2:] > boxes[:, :2]).all())
                and fewest_blend_launches(launches["attack"]) > 0):
            raise AssertionError(f"phase 8c gates failed: {summary['attack']}, {launches}")
        adv_model = os.path.join(work, "adv_model")
        save_scene_ply(res.scene, os.path.join(adv_model, "point_cloud", "iteration_1",
                                               "point_cloud.ply"))

        # 8d: render-eval on the trained (benign) and the attacked scene.
        logs = {}
        for tag, mp in (("benign", model), ("adv", adv_model)):
            logs[tag] = os.path.join(work, f"{tag}_render.log")
            before = dict(launches.get("render-eval", {}))
            with render_log(logs[tag]):
                rc, wall, _ = run_cli(
                    ["render-eval", *[o for o in common if "model_path" not in o],
                     f"scene.model_path={mp}", "combine_splats=false", "no_groups=true",
                     "write_images=false", *CLI_DETECTOR, "scene.target=car"],
                    launches, "render-eval")
            run = {k: launches["render-eval"][k] - before.get(k, 0) for k in ("fwd", "bwd")}
            with open(logs[tag]) as f:
                records = [json.loads(line.split(" - ")[-1]) for line in f if '"cam"' in line]
            seen = sum(1 for r in records if r["gt_bbox"][2] > 0 and r["gt_bbox"][3] > 0)
            summary[f"render_eval_{tag}"] = {
                "rc": rc, "s_per_camera": wall / len(exts), "records": len(records),
                "silhouettes": seen, "launches": run,
                "pred_classes": [r["pred_class"] for r in records]}
            log(f"  render-eval {tag}: {wall / len(exts):.3f} s per camera; "
                f"{summary[f'render_eval_{tag}']}")
            if not (rc == 0 and len(records) == seen == len(exts)
                    and run == {"fwd": 2 * len(exts), "bwd": 0}):
                raise AssertionError(f"phase 8d gates failed: {summary}")

        # 8e: asr and coco-ap over the two logs.
        rc_asr, _, lines = run_cli(["asr", "--benign-log", logs["benign"], "--adv-log",
                                    logs["adv"], "--target", "car"], launches, "asr", device=False)
        rc_ap, _, ap_lines = run_cli(["coco-ap", "--log", logs["benign"], "--target-class", "car",
                                      "--out-dir", work], launches, "coco-ap", device=False)
        parsed = [len(load_preds(logs[t])) for t in ("benign", "adv")]
        summary["asr"] = {"rc": rc_asr, "line": [x for _, x in lines], "cameras": parsed,
                          "coco_ap_rc": rc_ap, "coco_ap": [x for _, x in ap_lines]}
        log(f"  asr / coco-ap: {summary['asr']}")
        if not (rc_asr == 0 and rc_ap == 0 and parsed == [len(exts)] * 2):
            raise AssertionError(f"phase 8e gates failed: {summary['asr']}")

        # 8f: recolor, combine, grouping-render, the convex hull.
        for mode in ("single", "random", "grayscale", "sepia"):
            out = os.path.join(work, f"recolor_{mode}.ply")
            rc, _, _ = run_cli(["recolor", "--ply", ply, "--out", out, "--mode", mode],
                               launches, "recolor")
            sc = load_scene_ply(out, device=device)
            if not (rc == 0 and sc.num_points == trained.num_points
                    and float(sc.f_rest.abs().max()) == 0.0):
                raise AssertionError(f"phase 8f: recolor {mode} failed (rc {rc})")
        comb = os.path.join(work, "combined")
        rc, wall, _ = run_cli(["combine", "--plys", ply, bg_ply, "--scene-dir", src,
                               "--out-dir", comb, "--out-ply",
                               os.path.join(work, "combined.ply")], launches, "combine")
        shapes = [read_png(os.path.join(comb, f"render_{i:04d}.png")).shape
                  for i in range(len(exts))]
        summary["combine"] = {"rc": rc, "wall_s": wall, "launches": launches["combine"]}
        if not (rc == 0 and shapes == [(TRAIN_SIZE, TRAIN_SIZE, 3)] * len(exts)
                and launches["combine"]["fwd"] == len(exts)):
            raise AssertionError(f"phase 8f: combine failed: {summary['combine']}, {shapes}")
        grp = os.path.join(work, "grouping")
        rc, wall, lines = run_cli(["grouping-render", "-m", model, "--out", grp,
                                   *[o for o in common if o.startswith(("--config", "scene.source",
                                                                        "sh_"))]],
                                  launches, "grouping-render")
        frames_out = sorted(os.listdir(os.path.join(grp, "renders")))
        try:
            import cv2  # noqa: F401
            has_cv2 = True
        except ImportError:
            has_cv2 = False
        video = [x for _, x in lines if "video:" in x]
        summary["grouping_render"] = {"rc": rc, "wall_s": wall, "frames": len(frames_out),
                                      "line": video, "opencv": has_cv2,
                                      "pillow": importlib.util.find_spec("PIL") is not None}
        if not (rc == 0 and len(frames_out) == len(exts)
                and (has_cv2 or (video and video[0].endswith("(video: None)")))):
            raise AssertionError(f"phase 8f: grouping-render failed: {summary['grouping_render']}")
        xyz = trained.xyz.cpu().numpy()
        t0 = time.perf_counter()
        inside = points_inside_convex_hull(xyz, xyz[:, 0] < 0)
        hull_s = time.perf_counter() - t0
        summary["hull"] = {"s": hull_s, "points": len(xyz), "selected": int((xyz[:, 0] < 0).sum()),
                           "inside": int(inside.sum())}
        log(f"  recolor x4, combine {summary['combine']}, grouping-render "
            f"{summary['grouping_render']}; hull {summary['hull']}")
        # The hull of the x < 0 splats lies in x < 0.
        if not (inside.any() and not inside[xyz[:, 0] >= 0].any()):
            raise AssertionError(f"phase 8f: hull: {summary['hull']}")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 8 CLI on the card in {summary['phase_s']:.1f} s; launches {launches}")
    return {"summary": summary, "launches": launches}


# Phase 9: the (views, splats) mesh on the card, its ranks as processes.
MESH_GLOO_SHAPE = (2, 2)  # 9a: 4 gloo ranks on the one card
MESH_TRAIN_SHAPE = (1, 2)  # 9b
MESH_TRAIN_ITERS = 150
GATE_MESH_LOSS = 1e-4
GATE_MESH_F_DC = 1e-5  # abs, as the JAX package's test_dagger_with_mesh
# The mesh's attack sums each gaussian's gradient over the bands and view
# blocks (a reduce-scatter) in another order than the unsharded attack
# does, and the toy head's ReLUs can turn an ulp into another step for a
# few splats, so its trajectory may leave the unsharded one (which is
# itself reproducible bit for bit: phase 4b). So 9a holds f_dc to the
# unsharded attack after the first 3 PGD iterations, as the JAX package's
# test_dagger_with_mesh does, and prints the distance of two unsharded
# runs there (the check's premise) and the mesh's distance from phase 4's
# after 7.
MESH_F_DC_ITERS = 3
GATE_MESH_TRAJECTORY = 1e-3  # 9b's 150 losses, mesh against Trainer(), max rel


def mesh_render_errors(mesh, scene, cams, pairs, band_tiles, objects: bool) -> dict:
    """Phase 9a: the sharded render of the whole scene (`shard_scene`, so
    that the whole gradient comes back on every rank) against the
    unsharded one on this rank's card, loss mean(render^2): RGB only, or
    with the 16 object channels blended and returned (19 channels)."""
    import torch

    from gsattack_torch.attack import render_views
    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import rasterize_views
    from gsattack_torch.parallel import render_views_sharded, shard_scene

    bg = torch.zeros(3, device=scene.device)

    def unsharded(sc):
        if not objects:
            return render_views(sc, cams, bg, pairs, MAX_CHUNKS, CHUNK, with_objects=False)
        proj = stack_projections([project(sc, cams.view_at(i)) for i in range(cams.num_views)])
        out = rasterize_views(proj, cams.width, cams.height, bg, pairs, CHUNK, MAX_CHUNKS)
        return torch.cat([out["render"], out["render_object"]], -1)

    def sharded(sc):
        return render_views_sharded(shard_scene(sc, mesh), cams, bg, mesh, pairs, CHUNK,
                                    MAX_CHUNKS, band_tiles=band_tiles, with_objects=objects,
                                    return_objects=objects)

    got = {}
    for name, fn in (("unsharded", unsharded), ("mesh", sharded)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        img = fn(scene.with_params(leaves))
        grads = torch.autograd.grad((img ** 2).mean(), list(leaves.values()), allow_unused=True)
        got[name] = (img.detach(), dict(zip(leaves, grads)))
    (img, grads), (ref, ref_grads) = got["mesh"], got["unsharded"]
    return {"channels": int(img.shape[-1]), "image_max_abs_err": float((img - ref).abs().max()),
            "grad_max_rel_err": {k: max_rel(grads[k], g) for k, g in ref_grads.items()
                                 if g is not None and float(g.abs().max()) > 0}}


def rank_9a(info, shape: tuple[int, int]) -> dict:
    """Phase 9a on one rank of a `shape` mesh: the sharded render (RGB and
    19 channels) against the unsharded one on the rank's card, over
    pair-balanced bands when the blend is tile-parallel, then phase 4's
    `run_dagger` on the mesh (`toy_dagger`)."""
    import torch
    import torch.distributed as dist

    from gsattack_torch.ops.project import project
    from gsattack_torch.ops.raster import _tiles
    from gsattack_torch.parallel import make_mesh, measure_tile_row_costs, plan_bands

    device = info["device"]
    mesh = make_mesh(shape, "cuda")
    scene, ext, cams, pairs = main_shapes(device)
    bands = None
    if 1 < shape[1] <= _tiles(cams.width, cams.height)[1]:
        with torch.no_grad():
            costs = sum(measure_tile_row_costs(project(scene, cams.view_at(i)), cams.width,
                                               cams.height, pairs) for i in range(cams.num_views))
        bands = plan_bands(costs, shape[1])
    out = {"bands": bands, "renders": {
        "rgb": mesh_render_errors(mesh, scene, cams, pairs, bands, objects=False),
        "19ch": mesh_render_errors(mesh, scene, cams, pairs, bands, objects=True)}}
    res, lines, out["launches"] = toy_dagger(scene, ext, device, mesh)
    out["losses"] = list(res.losses)
    short = toy_dagger(scene, ext, device, mesh, pgd_iters=MESH_F_DC_ITERS)[0]
    if dist.get_rank() == 0:
        out["lines"] = [line for _, line in lines if line.startswith("[Info]")]
        out["pgd_it_s"] = iteration_rate([t for t, line in lines if line.startswith("Iteration:")])
        out["f_dc"], out["f_dc_short"] = res.scene.f_dc.cpu(), short.scene.f_dc.cpu()
    return out


def unsharded_f_dc_reference(scene, ext, device) -> dict:
    """9a's f_dc reference: the unsharded attack for `MESH_F_DC_ITERS` PGD
    iterations, run twice: the first run's final f_dc, and how far the
    second's lies from it."""
    f = [toy_dagger(scene, ext, device, pgd_iters=MESH_F_DC_ITERS)[0].scene.f_dc.cpu()
         for _ in range(2)]
    return {"f_dc": f[0], "spread": float((f[1] - f[0]).abs().max())}


def mesh_dagger_summary(a: list, shape, ref_losses, ref_f_dc, short_ref) -> tuple[dict, list]:
    """Phase 9a's gates on every rank's `rank_9a` result: the losses
    against the unsharded run's (`ref_losses`), f_dc after
    `MESH_F_DC_ITERS` iterations against `unsharded_f_dc_reference`'s
    (`short_ref`), whose own spread must lie within the gate; f_dc after
    the whole run against `ref_f_dc` is reported: (summary, what failed)."""
    import numpy as np

    ref_losses = np.asarray(ref_losses)
    renders = {k: {"image_max_abs_err": max(r["renders"][k]["image_max_abs_err"] for r in a),
                   "grad_max_rel_err": max(max(r["renders"][k]["grad_max_rel_err"].values())
                                           for r in a)} for k in ("rgb", "19ch")}
    loss_err = max(float(np.max(np.abs(np.asarray(r["losses"]) - ref_losses) / np.abs(ref_losses)))
                   for r in a)
    f_dc_err = float((a[0]["f_dc_short"] - short_ref["f_dc"]).abs().max())
    summary = {"mesh": shape, "bands": a[0]["bands"], "renders": renders,
               "losses": a[0]["losses"], "loss_max_rel_err": loss_err,
               "f_dc_iters": MESH_F_DC_ITERS, "f_dc_max_abs_err": f_dc_err,
               "unsharded_f_dc_spread": short_ref["spread"],
               "f_dc_max_abs_err_whole_run": float((a[0]["f_dc"] - ref_f_dc).abs().max()),
               "pgd_it_s": a[0]["pgd_it_s"], "launches": [r["launches"] for r in a]}
    failed = []
    if not all(v["image_max_abs_err"] <= GATE_IMAGE and v["grad_max_rel_err"] <= GATE_GRAD
               for v in renders.values()):
        failed.append("render")
    if not all(len(r["losses"]) == len(ref_losses) for r in a) or not (
            loss_err <= GATE_MESH_LOSS and f_dc_err <= GATE_MESH_F_DC):
        failed.append("run_dagger")
    if short_ref["spread"] > GATE_MESH_F_DC:
        failed.append("the unsharded attack differs from itself within the f_dc check")
    failed += unlaunched(summary["launches"])
    return summary, failed


def unlaunched(launches: list) -> list:
    """The ranks that did not launch the blend's kernels (the forward, the
    backward and its per-gaussian sum), by their counts."""
    return [f"blend kernels not launched on rank {i}"
            for i, n in enumerate(launches) if not fewest_blend_launches(n)]


def rank_9b(info, path: str, shape: tuple[int, int]) -> dict:
    """Phase 9b on one rank of a `shape` mesh: `Trainer(mesh)` for phase
    7b's first 150 steps (the launch counts set to 0 just before and read
    just after), then phase 7a's gates from `Trainer()`'s final state
    (written by `mesh_train_reference` to `path`): one step's loss and
    gradients, and a densify pass that grows the capacity."""
    import torch

    from gsattack_torch.parallel import SPLATS_AXIS, make_mesh
    from gsattack_torch.train import Trainer

    device = info["device"]
    mesh = make_mesh(shape, "cuda")
    ref = torch.load(path, weights_only=False)  # written by this script's own process
    cams = [e.build(device=device) for e in ref["exts"]]
    gts = [g.to(device) for g in ref["gts"]]
    trainer = Trainer(ref["init"], ref["cfg"], cameras_extent=ref["extent"], mesh=mesh,
                      device=device)
    stamps = []
    torch.cuda.synchronize()
    zero_launch_counts()
    trainer.fit(cams, gts, iterations=ref["cfg"].iterations,
                log=lambda i, l: stamps.append((time.perf_counter(), l)))
    torch.cuda.synchronize()
    out = {"launches": launch_counts(), "losses": [l for _, l in stamps],
           "train_it_s": iteration_rate([t for t, _ in stamps[1:]]),
           "alive": int(trainer.full_state().scene.alive.sum())}

    trainer.set_full_state(ref["state"].to(device))
    loss, grads, mean2d, _ = trainer.loss_and_grads(cams[0], gts[0])
    block = lambda t: t.chunk(shape[1])[mesh.get_local_rank(SPLATS_AXIS)]  # noqa: E731
    want = ref["step"]
    grad_err = {k: max_rel(g.cpu(), block(want["grads"][k])) for k, g in grads.items()
                if float(want["grads"][k].abs().max()) > 0}
    grad_err["mean2d"] = max_rel(mean2d.cpu(), block(want["mean2d"]))
    out["step"] = {"loss_rel_err": abs(float(loss) - want["loss"]) / abs(want["loss"]),
                   "grad_max_rel_err": grad_err}

    trainer.cfg.densify_grad_threshold = ref["densify"]["threshold"]
    trainer.maybe_densify(trainer.cfg.densify_from_iter, noise=ref["densify"]["noise"].to(device))
    got, want = trainer.full_state().to("cpu"), ref["densify"]["state"]
    # The mesh rounds the capacity up to a multiple of the splats axis
    # with dead points; the rest is `Trainer()`'s state.
    n = want.scene.num_points
    tail_dead = got.scene.num_points - n < shape[1] and not bool(got.scene.alive[n:].any())
    equal, err = states_differ(first_rows(got, n), want)
    out["densify"] = {"states_equal": equal and tail_dead, "max_abs_err": err,
                      "capacity": [ref["state"].scene.num_points, got.scene.num_points]}
    return out


def first_rows(st, n: int):
    """A training state cut to its first `n` points."""
    import dataclasses

    from gsattack_torch.core.scene import PARAM_NAMES

    rows = lambda d: {k: v[:n] for k, v in d.items()}  # noqa: E731
    return dataclasses.replace(
        st, scene=st.scene.replace(**rows({k: getattr(st.scene, k)
                                           for k in PARAM_NAMES + ("alive",)})),
        mu=rows(st.mu), nu=rows(st.nu), stats=type(st.stats)(*(v[:n] for v in st.stats)))


def mesh_train_summary(b: list, shape, plain: dict) -> tuple[dict, list]:
    """Phase 9b's gates on every rank's `rank_9b` result against
    `mesh_train_reference`'s `plain`: (summary, what failed)."""
    import numpy as np

    traj_err = max(float(np.max(np.abs(np.asarray(r["losses"]) - plain["losses"])
                                / np.abs(plain["losses"]))) for r in b)
    step = {"loss_rel_err": max(r["step"]["loss_rel_err"] for r in b),
            "grad_max_rel_err": {k: max(r["step"]["grad_max_rel_err"][k] for r in b)
                                 for k in b[0]["step"]["grad_max_rel_err"]}}
    summary = {"mesh": shape, "steps": MESH_TRAIN_ITERS, "trajectory_loss_max_rel_err": traj_err,
               "alive": [plain["alive"]] + [r["alive"] for r in b], "step": step,
               "densify": b[0]["densify"], "threshold": plain["threshold"],
               "train_it_s": b[0]["train_it_s"], "plain_train_it_s": plain["train_it_s"],
               "launches": [r["launches"] for r in b]}
    failed = []
    if not (traj_err <= GATE_MESH_TRAJECTORY and step["loss_rel_err"] <= GATE_TRAIN_LOSS
            and max(step["grad_max_rel_err"].values()) <= GATE_GRAD
            and all(r["densify"]["states_equal"] and r["densify"]["max_abs_err"] <= GATE_DENSIFY
                    and r["densify"]["capacity"][1] > r["densify"]["capacity"][0] for r in b)):
        failed.append("Trainer(mesh)")
    return summary, failed + unlaunched(summary["launches"])


def rank_9c(info, pairs: int) -> dict:
    """Phase 9c on the one NCCL rank of a (1, 1) mesh: phase 6's
    `run_dagger` against yolov8n@640, the launch counts set to 0 just
    before and read just after."""
    import torch

    from gsattack_torch.attack import run_dagger
    from gsattack_torch.models import load_detector
    from gsattack_torch.parallel import make_mesh

    device = info["device"]
    mesh = make_mesh((1, 1), "cuda")
    scene, ext, _, _ = main_shapes(device)
    det = load_detector("yolov8", seed=0, device=device)
    lines = []
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        zero_launch_counts()
        res = run_dagger(scene, [ext], det, detector_attack_config("yolov8", pairs, out_dir),
                         mesh=mesh, log=lambda line: lines.append((time.perf_counter(), line)))
        torch.cuda.synchronize()
    return {"launches": launch_counts(), "losses": list(res.losses), "backend": info["backend"],
            "pgd_it_s": iteration_rate([t for t, l in lines if l.startswith("Iteration:")])}


def mesh_train_reference(train_inputs: dict, device, path: str) -> dict:
    """Phase 9b's reference on this process's card: `Trainer()` for the
    same 150 steps, then from its final state one step (loss, gradients,
    mean2d gradient) and a densify pass at a threshold at the lower
    quartile of the gradients, with fixed draws, so that the children
    overflow the free slots; all of it saved to `path` for the ranks."""
    import dataclasses

    import torch

    from gsattack_torch.train import Trainer
    from gsattack_torch.train.densify import N_SPLIT

    cfg = dataclasses.replace(train_inputs["cfg"], iterations=MESH_TRAIN_ITERS)
    rank_cfg = dataclasses.replace(cfg)  # the threshold below is the reference's own
    exts, gts = train_inputs["exts"], [g.to(device) for g in train_inputs["gts"]]
    cams = [e.build(device=device) for e in exts]
    trainer = Trainer(train_inputs["init"], cfg, cameras_extent=train_inputs["extent"],
                      device=device)
    stamps = []
    trainer.fit(cams, gts, iterations=cfg.iterations,
                log=lambda i, l: stamps.append((time.perf_counter(), l)))
    torch.cuda.synchronize()
    state = trainer.state
    loss, grads, mean2d, _ = trainer.loss_and_grads(cams[0], gts[0])
    st = trainer.state
    hot = st.stats.xyz_gradient_accum / st.stats.denom.clamp(min=1.0)
    thr = float(torch.quantile(hot[st.stats.denom > 0], 0.25))
    noise = torch.randn((N_SPLIT, st.scene.num_points, 3),
                        generator=torch.Generator().manual_seed(9))
    trainer.cfg.densify_grad_threshold = thr
    trainer.maybe_densify(cfg.densify_from_iter, noise=noise.to(device))
    ref = {"exts": exts, "gts": [g.cpu() for g in gts], "init": train_inputs["init"],
           "cfg": rank_cfg, "extent": train_inputs["extent"],
           "state": state.to("cpu"),
           "step": {"loss": float(loss), "grads": {k: v.cpu() for k, v in grads.items()},
                    "mean2d": mean2d.cpu()},
           "densify": {"threshold": thr, "noise": noise, "state": trainer.state.to("cpu")}}
    torch.save(ref, path)
    return {"losses": [l for _, l in stamps],
            "train_it_s": iteration_rate([t for t, _ in stamps[1:]]),
            "alive": int(state.scene.alive.sum()), "threshold": thr}


def phase_mesh(main: dict, detectors: dict, train_inputs: dict, device) -> dict:
    """Phase 9: the (views, splats) mesh on the card, each rank a spawned
    process (`gsattack_torch.parallel.run_local`) that loads the kernel
    library phase 1 built. (a) 4 gloo ranks of a (2, 2) mesh, all on
    cuda:0: the sharded render of phase 4's scene, 4 views at 800x800, RGB
    and 19 channels, against the unsharded one (images 1e-5 abs,
    gradients 1e-3 max rel) and phase 4's `run_dagger` on the mesh against
    phase 4's (losses 1e-4 rel; f_dc 1e-5 abs after `MESH_F_DC_ITERS`
    iterations against the unsharded run's); (b) 2 gloo ranks of a
    (1, 2) mesh: `Trainer(mesh)` for phase 7b's first 150 steps (one
    densify pass) against `Trainer()` (losses 1e-3 max rel), then phase
    7a's gates from `Trainer()`'s final state; (c) one NCCL rank, a (1, 1)
    mesh: phase 6's `run_dagger` against yolov8n@640 (losses 1e-4 rel
    against phase 6's). Each rank must launch both blend kernels."""
    import numpy as np
    import torch

    from gsattack_torch.parallel import run_local

    t0 = time.perf_counter()
    summary, failed = {}, []
    a = run_local(rank_9a, 4, args=(MESH_GLOO_SHAPE,), backend="gloo", device="cuda", threads=2,
                  timeout=900)
    scene, ext, _, _ = main_shapes(device)
    short_ref = unsharded_f_dc_reference(scene, ext, device)
    del scene
    summary["9a"], bad = mesh_dagger_summary(a, MESH_GLOO_SHAPE, main["losses"], main["f_dc"],
                                             short_ref)
    summary["9a"]["backend"] = "gloo"
    failed += [f"9a {f}" for f in bad]
    log(f"phase 9a {MESH_GLOO_SHAPE} mesh, 4 gloo ranks on cuda:0 (gloo takes the CUDA tensors "
        f"and copies them through host memory itself): bands {a[0]['bands']}; render vs "
        f"unsharded {summary['9a']['renders']}; run_dagger {len(a[0]['losses'])} PGD "
        f"iterations, losses max rel {summary['9a']['loss_max_rel_err']:.2e} and f_dc max abs "
        f"{summary['9a']['f_dc_max_abs_err_whole_run']:.2e} against phase 4's; f_dc after "
        f"{MESH_F_DC_ITERS} iterations {summary['9a']['f_dc_max_abs_err']:.2e} against the "
        f"unsharded run's (two unsharded runs {summary['9a']['unsharded_f_dc_spread']:.2e} "
        f"apart); PGD "
        f"{a[0]['pgd_it_s']:.3f} it/s (phase 4: {main['rates']['pgd_it_s']:.3f}); "
        f"{a[0]['lines']}; launches by rank {summary['9a']['launches']}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_reference.pt")
        plain = mesh_train_reference(train_inputs, device, path)
        b = run_local(rank_9b, 2, args=(path, MESH_TRAIN_SHAPE), backend="gloo", device="cuda",
                      threads=4, timeout=900)
    summary["9b"], bad = mesh_train_summary(b, MESH_TRAIN_SHAPE, plain)
    summary["9b"]["backend"] = "gloo"
    failed += [f"9b {f}" for f in bad]
    log(f"phase 9b {MESH_TRAIN_SHAPE} mesh, 2 gloo ranks: Trainer(mesh) {MESH_TRAIN_ITERS} steps "
        f"at {b[0]['train_it_s']:.3f} it/s (Trainer() {plain['train_it_s']:.3f} it/s), losses max "
        f"rel {summary['9b']['trajectory_loss_max_rel_err']:.2e}, alive "
        f"{summary['9b']['alive']}; from Trainer()'s final state: step {summary['9b']['step']}, "
        f"densify (threshold {plain['threshold']:.3e}) {b[0]['densify']}; launches by rank "
        f"{summary['9b']['launches']}")

    (c,) = run_local(rank_9c, 1, args=(main["pairs_per_gaussian"],), backend="nccl",
                     device="cuda", threads=8, timeout=900)
    ref = np.asarray(detectors["yolov8"]["pgd_losses"])
    c_err = float(np.max(np.abs(np.asarray(c["losses"]) - ref) / np.abs(ref)))
    summary["9c"] = {"mesh": (1, 1), "backend": c["backend"], "losses": c["losses"],
                     "loss_max_rel_err": c_err, "pgd_it_s": c["pgd_it_s"],
                     "launches": [c["launches"]]}
    log(f"phase 9c (1, 1) mesh, one {c['backend']} rank: run_dagger against yolov8n@640, losses "
        f"{c['losses']} max rel {c_err:.2e} against phase 6's; PGD {c['pgd_it_s']:.3f} it/s "
        f"(phase 6: {detectors['yolov8']['pgd_it_s']:.3f}); launches {c['launches']}")
    if not (len(c["losses"]) == len(ref) and c_err <= GATE_MESH_LOSS):
        failed.append("9c")
    failed += [f"9c {f}" for f in unlaunched(summary["9c"]["launches"])]
    summary["phase_s"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"phase 9 gates failed: {failed}: {summary}")
    return summary


def phase_profile_viewer(scene, cams, pairs, device) -> dict:
    """Phase 10: `utils/profiling.py` and `utils/viewer.py` on the card.
    Two of phase 4's loss-and-step iterations (toy head) under `trace_to`,
    each stage in an `annotate` span and a `StageTimer` stage that waits
    for the card: the trace names every span and has kernel events, the
    timer's summary lists every stage. Then `serve_scene` on phase 4's
    scene in a daemon thread answers two `request_frame` calls over
    localhost (two of the 800x800 views): each frame equals `render` of
    the request's camera quantised to RGB8."""
    import socket
    import threading

    import numpy as np
    import torch

    from gsattack_torch.attack import render_views
    from gsattack_torch.attack.pgd import pgd_attack_step
    from gsattack_torch.models import ToyDetector
    from gsattack_torch.render import render
    from gsattack_torch.utils.profiling import TRACE_FILE, StageTimer, annotate, trace_to
    from gsattack_torch.utils.viewer import camera_from_request, request_frame, serve_scene

    det = ToyDetector(num_classes=8, seed=0, device=device)
    bg = torch.zeros(3, device=device)
    boxes = np.tile(np.array([[200, 200, 600, 600]], np.float32), (cams.num_views, 1))
    originals = scene.params()
    timer, spans = StageTimer(), ("pgd/render", "pgd/loss", "pgd/backward", "pgd/step")
    state = scene
    with tempfile.TemporaryDirectory() as d:
        with trace_to(d):
            for _ in range(2):
                leaves = {k: v.detach().requires_grad_(True) for k, v in state.params().items()}
                out = []
                with annotate(spans[0]), timer.stage(spans[0], block_on=out):
                    out.append(render_views(state.with_params(leaves), cams, bg, pairs,
                                            MAX_CHUNKS, CHUNK))
                with annotate(spans[1]), timer.stage(spans[1], block_on=out):
                    out.append(det.loss(out[0], 2, boxes))
                with annotate(spans[2]), timer.stage(spans[2], block_on=out):
                    grads = dict(zip(leaves, torch.autograd.grad(out[1], list(leaves.values()),
                                                                 allow_unused=True)))
                    out.append(list(g for g in grads.values() if g is not None))
                grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                         for k, g in grads.items()}
                with annotate(spans[3]), timer.stage(spans[3], block_on=out):
                    state = pgd_attack_step(state, grads, originals, 0.5, 5.0)
                    out.append(state.f_dc)
        with open(os.path.join(d, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    summary = timer.summary()
    log(f"phase 10 trace of 2 PGD iterations: {len(events)} events, {kernels} kernel events, "
        f"spans {[s for s in spans if s in names]}; StageTimer:\n" + summary)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready = threading.Event()
    server = threading.Thread(target=serve_scene, args=(scene,), daemon=True,
                              kwargs={"port": port, "max_requests": 2, "ready_event": ready})
    server.start()
    if not ready.wait(60):
        raise AssertionError("phase 10: the viewer did not listen")
    frames, diffs = [], []
    for vi in range(2):
        cam = cams.view_at(vi)
        req = {"width": cam.width, "height": cam.height, "fovx": 2 * math.atan(float(cam.tanfovx)),
               "fovy": 2 * math.atan(float(cam.tanfovy)), "view": cam.view.cpu().tolist()}
        t0 = time.perf_counter()
        got = request_frame(req, port=port)
        frames.append(time.perf_counter() - t0)
        with torch.no_grad():
            img = render(scene, camera_from_request(req, device), bg)["render"]
        want = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        diffs.append(int(np.abs(got.astype(int) - want.astype(int)).max()))
    server.join(timeout=60)
    log(f"  viewer on localhost: 2 frames of {cams.width}x{cams.height} in "
        f"{[round(t, 3) for t in frames]} s, max RGB8 difference from render {diffs}")
    checks = {"spans traced": all(s in names for s in spans), "kernel events": kernels > 0,
              "timer summary": all(s in summary for s in spans),
              "frames equal": diffs == [0, 0], "server done": not server.is_alive()}
    if not all(checks.values()):
        raise AssertionError(f"phase 10 gates failed: {[k for k, v in checks.items() if not v]}")
    return {"trace_events": len(events), "kernel_events": kernels, "frame_s": frames,
            "stage_s": dict(timer.totals)}


# Phase 11: the static caps of the reference's Pallas route on the card.
AUTO_CAPS = dict(backend="pallas", pairs_per_gaussian=-1, rect_candidates=-1,
                 pairs_budget=-1, compact_budget=-1, tier_split=-1, heavy_budget=-1)
CAPS_TRAIN_ITERS = 50


def cap_drops(proj, width: int, height: int, pairs: int, rect: int, caps: dict) -> dict:
    """The pairs each cap of `caps` drops from one view's binning, each cap
    alone: the tiered bin's (culled beyond the untiered binning's),
    pairs_budget's and compact_budget's; and all of them together."""
    from gsattack_torch.ops.raster import bin_gaussians

    def bins(**kw):
        return bin_gaussians(proj.mean2d, proj.depth, proj.radius_tight, width, height, pairs,
                             conic=proj.conic, opacity=proj.opacity, rect_candidates=rect, **kw)

    base = int(bins().num_culled_pairs)
    tier = bins(tier_split=caps["tier_split"], heavy_budget=caps["heavy_budget"])
    together = bins(**caps)
    return {"tier": int(tier.num_culled_pairs) - base,
            "pairs_budget": int(bins(pairs_budget=caps["pairs_budget"]).num_dropped_pairs),
            "compact_budget": int(bins(compact_budget=caps["compact_budget"]).num_dropped_pairs),
            "together": int(together.num_culled_pairs) - base + int(together.num_dropped_pairs)}


def phase_caps(scene, cams, ext, main: dict, train_inputs: dict, device) -> dict:
    """Phase 11: the static caps. (a) Phase 4's `run_dagger` on the
    "pallas" route with every cap at -1 (sized by the probes): the sizes,
    no pair dropped at them, the losses and final f_dc against phase 4's
    uncapped run (1e-4 rel and 1e-5 abs, as phase 9a's; bit-equal is
    expected and reported), its PGD it/s. (b) On view 0, pairs_budget,
    compact_budget and heavy_budget (at the probe's tier_split, or 1
    where the tier does not pay) at half their probed sizes: each cap's
    dropped pairs on the card above 0 and equal to the port's binning on
    the CPU, and both kernels against the plain version under all of them
    with phase 3's gates. (c) `Trainer` with `auto_caps`-sized caps on the
    "pallas" route for phase 7b's first 50 steps: finite losses, every
    blend kernel launched."""
    import dataclasses

    import numpy as np
    import torch

    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import (
        _tiles, auto_caps, auto_compact_budget, auto_heavy_budget, auto_pair_caps,
        auto_pairs_budget, auto_tier_caps, bin_views, rasterize_views, resolve_caps,
    )
    from gsattack_torch.train import Trainer

    t0 = time.perf_counter()
    summary, failed = {}, []
    w, h = cams.width, cams.height
    # (a)
    with deterministic_cudnn():
        res, lines, launches = toy_dagger(scene, ext, device, overrides=AUTO_CAPS)
    with torch.no_grad():
        projs = [project(scene, cams.view_at(i)) for i in range(cams.num_views)]
        caps = resolve_caps([(p, w, h) for p in projs], *(-1,) * 6, log=lambda *_: None)
        out = rasterize_views(stack_projections(projs), w, h, torch.zeros(3, device=device),
                              caps["pairs_per_gaussian"], CHUNK, MAX_CHUNKS,
                              rect_candidates=caps["rect_candidates"],
                              **{k: v for k, v in caps.items() if k not in
                                 ("pairs_per_gaussian", "rect_candidates")}, backend="pallas")
    losses = np.asarray(res.losses)
    ref = np.asarray(main["losses"])
    f_dc = res.scene.f_dc.cpu()
    stamps = [t for t, line in lines if line.startswith("Iteration:")]
    a = {"caps": caps, "sized": [line for _, line in lines if line.startswith("[Info] Auto")],
         "num_truncated_pairs": int(out["num_truncated_pairs"]),
         "num_culled_pairs": int(out["num_culled_pairs"]),
         "losses": losses.tolist(), "losses_equal": losses.tolist() == ref.tolist(),
         "loss_max_rel_err": float(np.max(np.abs(losses - ref) / np.abs(ref)))
         if len(losses) == len(ref) else float("inf"),
         "f_dc_equal": torch.equal(f_dc, main["f_dc"]),
         "f_dc_max_abs_err": float((f_dc - main["f_dc"]).abs().max()),
         "pgd_it_s": iteration_rate(stamps), "launches": launches}
    summary["a"] = a
    log(f"phase 11a run_dagger, backend pallas, every cap -1: {a['sized']}; at these caps "
        f"{a['num_truncated_pairs']} pairs truncated, {a['num_culled_pairs']} culled over the 4 "
        f"views; {len(losses)} PGD iterations, losses equal to phase 4's {a['losses_equal']} "
        f"(max rel {a['loss_max_rel_err']:.2e}), f_dc equal {a['f_dc_equal']} (max abs "
        f"{a['f_dc_max_abs_err']:.2e}); PGD {a['pgd_it_s']:.3f} it/s (phase 4: "
        f"{main['rates']['pgd_it_s']:.3f}); launches {launches}")
    if not (a["num_truncated_pairs"] == 0 and a["loss_max_rel_err"] <= GATE_MESH_LOSS
            and a["f_dc_max_abs_err"] <= GATE_MESH_F_DC):
        failed.append("11a")
    failed += [f"11a {f}" for f in unlaunched([launches])]

    # (b)
    with torch.no_grad():
        proj = project(scene, cams.view_at(0))
        pairs, rect = auto_pair_caps(proj, w, h)
        ts = auto_tier_caps(proj, w, h, pairs, rect)[0] or 1
        half = {"tier_split": ts,
                "heavy_budget": auto_heavy_budget(proj, w, h, pairs, rect, ts) // 2,
                "pairs_budget": auto_pairs_budget(proj, w, h, pairs, rect_candidates=rect) // 2,
                "compact_budget": auto_compact_budget(proj, w, h, pairs,
                                                      rect_candidates=rect) // 2}
        card = cap_drops(proj, w, h, pairs, rect, half)
        cpu = cap_drops(proj._replace(**{k: v.cpu() for k, v in proj._asdict().items()}),
                        w, h, pairs, rect, half)
        stacked = stack_projections([proj])
        bins = bin_views(stacked, w, h, pairs, rect, **half)
    chans = torch.cat([stacked.color, stacked.obj], dim=-1)
    blend_in = [x.detach().contiguous().requires_grad_(True)
                for x in (stacked.mean2d, stacked.conic, stacked.opacity, chans)]
    cmp = kernels_vs_plain((bins.gauss_idx, bins.tile_start, bins.tile_end), blend_in,
                           _tiles(w, h), CHUNK * MAX_CHUNKS, slot_table=bins.slot_table)
    b = {"pairs_per_gaussian": pairs, "rect_candidates": rect, "caps": half,
         "dropped_card": card, "dropped_cpu": cpu, "image_max_abs_err": cmp["fwd_err"],
         "grad_max_rel_err": cmp["bwd_rel"]}
    summary["b"] = b
    log(f"phase 11b view 0 at half the probed caps {half} (pairs_per_gaussian {pairs}, "
        f"rect_candidates {rect}): dropped pairs on the card {card}, by the CPU's binning {cpu}; "
        f"kernel vs plain image/T max abs {cmp['fwd_err']:.3e}, gradients max rel "
        + ", ".join(f"{k} {e:.3e}" for k, e in cmp["bwd_rel"].items()))
    if not (card == cpu and min(card.values()) > 0 and cmp["fwd_err"] <= GATE_IMAGE
            and max(cmp["bwd_rel"].values()) <= GATE_GRAD):
        failed.append("11b")
    del cmp, blend_in, bins

    # (c)
    init = train_inputs["init"].to(device)
    exts, gts = train_inputs["exts"], [g.to(device) for g in train_inputs["gts"]]
    tcams = [e.build(device=device) for e in exts]
    with torch.no_grad():
        pairs, rect, budget, compact, (ts, hb) = auto_caps(project(init, tcams[0]),
                                                           tcams[0].width, tcams[0].height)
    cfg = dataclasses.replace(train_inputs["cfg"], iterations=CAPS_TRAIN_ITERS, backend="pallas",
                              pairs_per_gaussian=pairs, rect_candidates=rect,
                              pairs_budget=budget, compact_budget=compact, tier_split=ts,
                              heavy_budget=hb)
    trainer = Trainer(init, cfg, cameras_extent=train_inputs["extent"], device=device)
    tstamps = []
    torch.cuda.synchronize()
    zero_launch_counts()
    trainer.fit(tcams, gts, iterations=CAPS_TRAIN_ITERS,
                log=lambda i, l: tstamps.append((time.perf_counter(), l)))
    torch.cuda.synchronize()
    tl = launch_counts()
    del trainer
    wide = wide_sum(*trainer_slot_table(init, exts[0], device))
    tlosses = [l for _, l in tstamps]
    c = {"caps": dict(pairs_per_gaussian=pairs, rect_candidates=rect, pairs_budget=budget,
                      compact_budget=compact, tier_split=ts, heavy_budget=hb),
         "steps": len(tlosses), "first_loss": tlosses[0], "last_loss": tlosses[-1],
         "train_it_s": iteration_rate([t for t, _ in tstamps[1:]]), "launches": tl,
         "sum": wide}
    summary["c"] = c
    log(f"phase 11c Trainer, backend pallas, auto_caps {c['caps']}: {len(tlosses)} steps, loss "
        f"{tlosses[0]:.5f} -> {tlosses[-1]:.5f}, {c['train_it_s']:.3f} it/s; launches {tl}")
    log(f"  gather_sum_rows on the first step's slot table {wide['table']} (W {wide['w']}): "
        f"{wide['named']} slots named, in {wide['rows_naming_any']} rows, at most "
        f"{wide['most_in_a_row']} in a row, {wide['rows_naming_over_512']} rows over 512; equal "
        f"to plain {wide['equal']}; {wide['ms']:.4f} ms (bound {wide['bound_ms']:.4f} ms by "
        f"{wide['bound_by']})")
    if not (len(tlosses) == CAPS_TRAIN_ITERS and np.isfinite(tlosses).all()
            and tl["fwd"] >= CAPS_TRAIN_ITERS and tl["bwd"] >= CAPS_TRAIN_ITERS
            and tl["gather_sum"] >= CAPS_TRAIN_ITERS and wide["equal"]):
        failed.append("11c")
    summary["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 in {summary['phase_s']:.1f} s")
    if failed:
        raise AssertionError(f"phase 11 gates failed: {failed}: {summary}")
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from gsattack_torch.ops import _cuda
        from gsattack_torch.ops.raster import _tiles
    except ImportError as e:
        print(f"chip_smoke: gsattack_torch not found next to this script ({e})", file=sys.stderr)
        return 2

    # Full float32 on the card: cuDNN would run the toy head's float32
    # convolutions in TF32 by default.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1  card: {smi} ({kind}, torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"  kernels built from gsattack_torch/csrc in {build_s:.1f} s")

    phase_small(device, _tiles)
    phase_edge_tiles(device)
    scene, ext, cams, pairs = main_shapes(device)
    shapes = phase_main_shapes(scene, cams, pairs, _tiles)
    main = phase_main_path(scene, cams, ext, pairs, device)
    phase_reproducible(scene, cams, ext, pairs, shapes, main, device)
    del shapes["rerun"], shapes["grads"]
    gathered = phase_gather(device)
    detectors = phase_detectors(scene, cams, ext, pairs, device)
    del scene, cams
    torch.cuda.empty_cache()
    parity = phase_train_parity(device)
    trained = phase_train(device)
    cloak = phase_cloak(trained, device)
    log("phase 7 summary " + json.dumps({"train_vs_cpu": parity, "train": trained["summary"],
                                         "cloak": cloak}))
    train_launches = {k: {"train": trained["summary"]["launches"][k],
                          "cloak": cloak["launches"][k]} for k in ("fwd", "bwd", "gather_sum")}
    train_inputs = {"init": trained["init"].to("cpu"), "exts": trained["exts"],
                    "gts": [g.cpu() for g in trained["gts"]], "cfg": trained["cfg"],
                    "extent": trained["extent"]}
    del trained
    torch.cuda.empty_cache()
    cli = phase_cli(device)
    log("phase 8 summary " + json.dumps(cli["summary"]))
    cli_launches = {k: {cmd: n[k] for cmd, n in cli["launches"].items() if n[k]}
                    for k in ("fwd", "bwd", "gather_sum")}
    torch.cuda.empty_cache()
    mesh = phase_mesh(main, detectors, train_inputs, device)
    log(f"phase 9 summary ({smi}) " + json.dumps(mesh))
    mesh_launches = {k: {p: [n[k] for n in mesh[p]["launches"]] for p in ("9a", "9b", "9c")}
                     for k in ("fwd", "bwd", "gather_sum", "gather")}
    scene, ext, cams, pairs = main_shapes(device)
    tools = phase_profile_viewer(scene, cams, pairs, device)
    log("phase 10 summary " + json.dumps(tools))
    caps = phase_caps(scene, cams, ext, main, train_inputs, device)
    log("phase 11 summary " + json.dumps(caps))
    w16 = gathered["widths"][16]

    source = "gsattack_torch/csrc/blend.cu"
    kernels = [
        {"name": "blend_fwd", "route": "cuda", "source": source,
         "replaces": "gsattack/ops/pallas_blend.py:157", "launches": main["launches"]["fwd"],
         "training_launches": train_launches["fwd"], "cli_launches": cli_launches["fwd"],
         "mesh_launches": mesh_launches["fwd"],
         **{k: shapes["fwd"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by")},
         "library_ms": None},
        {"name": "blend_bwd", "route": "cuda", "source": source,
         "replaces": "gsattack/ops/pallas_blend.py:233", "launches": main["launches"]["bwd"],
         "training_launches": train_launches["bwd"], "cli_launches": cli_launches["bwd"],
         "mesh_launches": mesh_launches["bwd"],
         **{k: shapes["bwd"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by")},
         "library_ms": None, "with_gather_sum_ms": shapes["backward"]["ms"],
         "fused_atomic_ms": FUSED_BWD_MS},
        {"name": "gather_sum_rows", "route": "cuda", "source": "gsattack_torch/csrc/gather_sum.cu",
         "replaces": "gsattack/ops/pallas_blend.py:575", "launches": main["launches"]["gather_sum"],
         "training_launches": train_launches["gather_sum"],
         "cli_launches": cli_launches["gather_sum"], "mesh_launches": mesh_launches["gather_sum"],
         "caps_launches": caps["a"]["launches"]["gather_sum"],
         **{k: shapes["gather_sum"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
         "wide_ms": caps["c"]["sum"]["ms"], "wide_bound_ms": caps["c"]["sum"]["bound_ms"],
         "wide_table": caps["c"]["sum"]["table"]},
        {"name": "gather_rows", "route": "cuda", "source": "gsattack_torch/csrc/gather.cu",
         "replaces": "gsattack/ops/pallas_gather.py:35", "launches": main["launches"]["gather"],
         "micro_bench_launches": gathered["micro_bench_launches"],
         "mesh_launches": mesh_launches["gather"],
         "max_abs_err": max(r["max_abs_err"] for r in gathered["widths"].values()),
         **{k: w16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "by_width": {str(w): {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                      for w, r in gathered["widths"].items()}},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
