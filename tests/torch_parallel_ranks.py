"""What each rank of `tests/test_torch_parallel.py`'s gloo groups runs.
The ranks are spawned processes (`gsattack_torch.parallel.run_local`),
so this module imports neither JAX nor `gsattack`: the inputs come from
the test's process (the JAX package's toy scenes, carried across), and
the results go back to it as numpy arrays."""

import contextlib
import io
from pathlib import Path

import numpy as np
import torch

from gsattack_torch.attack import AttackConfig, render_views, run_dagger
from gsattack_torch.attack.cloak import CloakConfig, run_cloak
from gsattack_torch.core.camera import CameraExtrinsics
from gsattack_torch.models import ToyDetector
from gsattack_torch.ops.project import project
from gsattack_torch.parallel import (
    initialize_distributed,
    make_mesh,
    measure_tile_row_costs,
    plan_bands,
)
from gsattack_torch.train import TrainConfig, Trainer

# name: (splats, views, width, height, band_tiles, return_objects,
# pairs_per_gaussian). On a (2, 2) mesh: 48x64 has 4 tile rows for 2
# bands; "measured" plans the bands from the scene's pair costs; 72 rows
# tile to 5 (ceil), so the bands are uneven and the last is cropped; 63
# splats pad to 64; 3 views do not divide the views axis (replicated); 16
# rows are one tile row, fewer than the bands (the blend replicated over
# splats); 2 pairs a gaussian cull the candidate tiles of the larger
# splats, which each band must cull as the whole image does.
RENDER_CASES = {
    "rgb": (64, 4, 48, 64, None, False, 32),
    "objects": (64, 4, 48, 64, None, True, 32),
    "uneven_bands": (64, 4, 48, 64, (1, 3), False, 32),
    "measured_bands": (64, 4, 48, 64, "measured", False, 32),
    "odd_height": (64, 4, 48, 72, None, False, 32),
    "indivisible_splats": (63, 4, 48, 64, None, False, 32),
    "indivisible_views": (64, 3, 48, 64, None, False, 32),
    "replicated_blend": (64, 4, 48, 16, None, False, 32),
    "culled_pairs": (64, 4, 48, 64, None, False, 2),
}
# name: (batch size, AttackConfig settings): the last on the "pallas" route
# with every static cap sized by the probes (-1).
DAGGER_CASES = {
    "dagger": (2, {}),
    "dagger_replicated_views": (3, {}),
    "dagger_auto_caps": (2, dict(backend="pallas", pairs_per_gaussian=-1, rect_candidates=-1,
                                 pairs_budget=-1, compact_budget=-1, tier_split=-1,
                                 heavy_budget=-1)),
}


def loss_and_grads(render_fn, scene):
    """mean(render^2) of `render_fn(scene)` and its gradient by parameter."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    img = render_fn(scene.with_params(leaves))
    got = torch.autograd.grad((img ** 2).mean(), list(leaves.values()), allow_unused=True)
    grads = {k: np.zeros(tuple(leaves[k].shape), np.float32) if g is None else g.numpy()
             for k, g in zip(leaves, got)}
    return img.detach().numpy(), grads


def render_case(scene, cams, case, mesh=None):
    """One of RENDER_CASES: the render and its gradients, sharded over
    `mesh` or not."""
    _, _, _, _, band_tiles, objects, pairs = RENDER_CASES[case]
    if band_tiles == "measured":
        with torch.no_grad():
            costs = sum(measure_tile_row_costs(project(scene, cams.view_at(i)), cams.width,
                                               cams.height) for i in range(cams.num_views))
        band_tiles = plan_bands(costs, 2)
    if mesh is None:
        fn = lambda sc: render_views(sc, cams, torch.zeros(3), pairs)  # noqa: E731
        if objects:
            from gsattack_torch.ops.project import stack_projections
            from gsattack_torch.ops.raster import rasterize_views

            def fn(sc):
                proj = stack_projections([project(sc, cams.view_at(i))
                                          for i in range(cams.num_views)])
                out = rasterize_views(proj, cams.width, cams.height, torch.zeros(3), pairs)
                return torch.cat([out["render"], out["render_object"]], -1)
    else:
        from gsattack_torch.parallel import render_views_sharded, shard_scene

        def fn(sc):
            return render_views_sharded(shard_scene(sc, mesh), cams, torch.zeros(3), mesh,
                                        pairs, band_tiles=band_tiles, return_objects=objects)
    return loss_and_grads(fn, scene)


def dagger_views():
    return [CameraExtrinsics(np.eye(3), np.array([0.0, 0.0, 0.05 * i]), 1.0, 1.0, 64, 64)
            for i in range(3)]


def dagger_case(scene, frozen, mask, case, mesh=None):
    """`run_dagger` with the toy head over a frozen overlay and a mask:
    (losses, final f_dc, per-view successes, log lines)."""
    batch, caps = DAGGER_CASES[case]
    cfg = AttackConfig(max_iters=3, batch_mode=True, batch_size=batch, target=2,
                       eval_every=1, attack_conf_thresh=0.9, save_ply=False, **caps)
    lines = []
    det = ToyDetector(num_classes=8, seed=0, device="cpu")
    res = run_dagger(scene, dagger_views()[: cfg.batch_size], det, cfg, frozen_scene=frozen,
                     attack_mask=mask, log=lines.append, mesh=mesh)
    return np.asarray(res.losses), res.scene.f_dc.numpy(), res.per_view_success, lines


def train_config(**kw):
    """Densify every 4 steps from step 4 with a threshold every point
    passes (clone and split children overflow the free slots, so the
    capacity grows), the SH degree up every 5 steps, the grouping
    regulariser on."""
    return TrainConfig(densify_from_iter=4, densification_interval=4, densify_until_iter=100,
                       densify_grad_threshold=1e-9, opacity_reset_interval=1000,
                       sh_increase_interval=5, capacity_headroom=1.5, percent_dense=0.5,
                       use_reg3d=True, reg3d_interval=2, reg3d_sample_size=20, **kw)


def train_case(scene, cams, gts, classifier, mesh=None):
    """9 steps of `Trainer.fit` (densify passes at 4 and 8): (losses, the
    whole final state as numpy)."""
    trainer = Trainer(scene, train_config(), classifier=classifier, mesh=mesh, device="cpu")
    losses = []
    trainer.fit(cams, gts, iterations=9, log=lambda i, l: losses.append(l))
    st = trainer.full_state()
    state = {f"scene.{k}": v.numpy() for k, v in st.scene.params().items()}
    state.update({f"mu.{k}": v.numpy() for k, v in st.mu.items()})
    state.update({f"stats.{i}": v.numpy() for i, v in enumerate(st.stats)})
    state["scene.alive"] = st.scene.alive.numpy()
    return np.asarray(losses), state


def cloak_case(scene, cams, gts, mesh=None):
    """`run_cloak`: one poisoned view, 5 steps of retraining."""
    det = ToyDetector(num_classes=8, seed=0, device="cpu")
    ccfg = CloakConfig(epsilon=8 / 255, alpha=2 / 255, steps=3, target=2, is_targeted=True,
                       poison_view_indices=(0,))
    tcfg = TrainConfig(densify_from_iter=10_000, sh_increase_interval=10_000,
                       opacity_reset_interval=10_000)
    final, poisoned = run_cloak(scene, cams, gts, det, ccfg, train_cfg=tcfg, iterations=5,
                                log=lambda *_: None, mesh=mesh, device="cpu")
    return final.f_dc.numpy(), final.xyz.numpy(), poisoned[0].numpy()


REPO = Path(__file__).resolve().parents[1]
CLI_ARGS = ["attack", "max_iters=2", "batch_mode=true", "batch_size=2", "scene.n_points=64",
            "--device", "cpu", "--config-dir", str(REPO / "configs")]


def cli_attack(out_dir, mesh: bool):
    """`gsattack_torch.cli attack` on the synthetic toy scene; its
    standard output."""
    from gsattack_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(CLI_ARGS + [f"splat_asset_path={out_dir}"]
                      + (["use_mesh=true"] if mesh else []))
    return rc, buf.getvalue()


def truncated_pairs(scene, cams, mesh=None) -> int:
    """The batch's count of pairs past a 4-pair tile cap (chunk 2 x
    max_chunks 2), over uneven bands (1, 3) on a mesh."""
    from gsattack_torch.ops.project import stack_projections
    from gsattack_torch.ops.raster import rasterize_views
    from gsattack_torch.parallel import render_sharded, shard_scene

    with torch.no_grad():
        if mesh is not None:
            return int(render_sharded(shard_scene(scene, mesh), cams, torch.zeros(3), mesh,
                                      chunk=2, max_chunks=2, band_tiles=(1, 3))
                       ["num_truncated_pairs"])
        proj = stack_projections([project(scene, cams.view_at(i)) for i in range(cams.num_views)])
        return int(rasterize_views(proj, cams.width, cams.height, torch.zeros(3), chunk=2,
                                   max_chunks=2)["num_truncated_pairs"])


def group_2x2(info, scenes, cams, dagger_inputs):
    """The (2, 2) mesh's checks: every render case, the truncated-pair
    count, both DAGGER cases and `initialize_distributed`'s summary once
    joined."""
    mesh = make_mesh((2, 2), "cpu")
    out = {"info": {k: v for k, v in info.items() if k != "device"},
           "joined_again": initialize_distributed("gloo", device="cpu", expect_devices=4)}
    out["joined_again"].pop("device")
    for case, (n, *_rest) in RENDER_CASES.items():
        out[case] = render_case(scenes[n], cams[case], case, mesh)
    out["truncated"] = truncated_pairs(scenes[64], cams["rgb"], mesh)
    for case in DAGGER_CASES:
        out[case] = dagger_case(*dagger_inputs, case, mesh)
    return out


def group_1x2(info, train_inputs, cloak_inputs, out_dir):
    """The (1, 2) mesh's checks: the trainer through a growing densify,
    CLOAK, and the command line's `attack` with `use_mesh=true` (auto
    shape: the gcd of the batch of 2 and the 2 devices views, 1 splats)."""
    mesh = make_mesh((1, 2), "cpu")
    return {"train": train_case(*train_inputs, mesh=mesh),
            "cloak": cloak_case(*cloak_inputs, mesh=mesh),
            "cli": cli_attack(out_dir, mesh=True)}
