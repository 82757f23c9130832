"""The (views, splats) mesh on the cards of one host, one process a card
over NCCL, at the main path's shapes (`chip_smoke.py` phases 3-4: 100k
splats, SH3, 4 views at 800x800):

    python -m torch.distributed.run --nproc-per-node N mesh_bench.py \\
        [--shapes 2x2 1x4] [--out FILE]

Rank 0 builds the kernels from `gsattack_torch/csrc/`; the other ranks
wait for it and load them. Each rank then runs `chip_smoke.py`'s phase 9
checks on its own card, with the mesh shape as their argument:

- phase 4's `run_dagger` (toy head) unsharded on rank 0, the reference;
- for each mesh shape (views x splats, multiplying to N; default (1, N)
  and (2, N/2) for even N > 2) `chip_smoke.rank_9a`: the sharded render
  against the unsharded one on the rank's card, RGB and 19 channels
  (images 1e-5 abs, every gradient 1e-3 max rel), then `run_dagger` on
  the mesh against the reference (losses 1e-4 rel; f_dc 1e-5 abs after
  `chip_smoke.MESH_F_DC_ITERS` PGD iterations), with its PGD it/s and
  each rank's blend launches;
- on a (1, N) mesh, `chip_smoke.rank_9b`: `Trainer(mesh)` for phase 7b's
  first 150 steps against `Trainer()` on rank 0's card
  (`chip_smoke.mesh_train_reference`), then phase 7a's gates, with both
  train it/s. The 3-NN initial scene comes from phase 7's target without
  the COLMAP round trip.

Rank 0 prints one JSON object with the card's `nvidia-smi` name and
power limit, and writes it to `--out`. Exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

import chip_smoke as cs
from gsattack_torch.core.scene import scene_from_points
from gsattack_torch.core.sh import sh_to_rgb_dc
from gsattack_torch.io.dataset import get_nerfpp_norm
from gsattack_torch.ops import _cuda
from gsattack_torch.parallel import initialize_distributed


def gathered(x) -> list:
    """Every rank's picklable `x`, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def mesh_shape(text: str) -> tuple[int, int]:
    views, splats = (int(v) for v in text.split("x"))
    return views, splats


def train_inputs(device) -> dict:
    """Phase 7's training problem for `chip_smoke.mesh_train_reference`:
    the 8 training views and their GT renders, and the 3-NN initial scene
    from the target's noisy centres."""
    target, exts, gts = cs.training_views(device)
    g = torch.Generator().manual_seed(11)
    pts = target.xyz.cpu() + torch.randn(target.xyz.shape, generator=g) * cs.TRAIN_POINT_NOISE
    cols = sh_to_rgb_dc(target.f_dc[:, 0].cpu()).clamp(0, 1)
    init = scene_from_points(pts.numpy(), cols.numpy(), max_sh_degree=3,
                             generator=torch.Generator().manual_seed(12), device="cpu")
    keep = [i for i in range(len(exts)) if i != cs.HELD_OUT]
    extent = get_nerfpp_norm([exts[i] for i in keep])["radius"]
    return {"init": init, "exts": [exts[i] for i in keep], "gts": [gts[i].cpu() for i in keep],
            "cfg": cs.train_config(extent, cs.TRAIN_SIZE), "extent": extent}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mesh_bench")
    ap.add_argument("--shapes", nargs="*", type=mesh_shape, default=None,
                    help="views x splats, e.g. 2x2; default (1, N) and (2, N/2) for even N > 2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    info = initialize_distributed("nccl")
    device, n = info["device"], info["num_processes"]
    rank0 = info["process_id"] == 0
    if rank0:
        _cuda.build()
    dist.barrier()
    shapes = args.shapes or [(1, n)] + ([(2, n // 2)] if n % 2 == 0 and n > 2 else [])
    summary = {"card": cs.nvidia_smi() if rank0 else None, "world": n, "backend": "nccl",
               "shapes": {}}
    failed = []
    if rank0:
        scene, ext, _, _ = cs.main_shapes(device)
        res, lines, _ = cs.toy_dagger(scene, ext, device)
        ref_losses, ref_f_dc = list(res.losses), res.scene.f_dc.cpu()
        summary["unsharded_pgd_it_s"] = cs.iteration_rate(
            [t for t, line in lines if line.startswith("Iteration:")])
        short_ref = cs.unsharded_f_dc_reference(scene, ext, device)
        del scene, res
    for shape in shapes:
        a = gathered(cs.rank_9a(info, shape))
        if rank0:
            row, bad = cs.mesh_dagger_summary(a, shape, ref_losses, ref_f_dc, short_ref)
            summary["shapes"]["x".join(map(str, shape))] = row
            failed += [f"{shape} {f}" for f in bad]

    with tempfile.TemporaryDirectory() as tmp:
        # Rank 0's file, sent once it is written.
        path = [os.path.join(tmp, "train_reference.pt")]
        plain = cs.mesh_train_reference(train_inputs(device), device, path[0]) if rank0 else None
        dist.broadcast_object_list(path, src=0)
        b = gathered(cs.rank_9b(info, path[0], (1, n)))
    if rank0:
        summary["train"], bad = cs.mesh_train_summary(b, (1, n), plain)
        failed += [f"train {f}" for f in bad]
        summary["failed"] = failed
        text = json.dumps(summary)
        print(text, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text + "\n")
    failed = gathered(failed)[0]
    dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
