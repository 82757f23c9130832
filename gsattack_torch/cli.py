"""Command-line entries, the port of `gsattack/cli.py`: the same ten
commands, options and config overrides.

  python -m gsattack_torch.cli attack [scene=<name>] [key=value ...]
      the DAGGER driver: scene set-up in the three modes (synthetic or
      whole scene / combined target + background PLYs / grouped object),
      detector, benign silhouette pass, batched PGD
  python -m gsattack_torch.cli render-eval [overrides]
      adversarial render evaluation (JSON records on the `render` logger)
  python -m gsattack_torch.cli sweep [--job render-eval|attack] [overrides with a,b]
      the cartesian product of comma-separated overrides, a run directory each
  python -m gsattack_torch.cli train [--iterations N] [--poison-views ...] [overrides]
      3DGS training (CLOAK with --poison-views)
  python -m gsattack_torch.cli grouping-render -m <model> [overrides]
  python -m gsattack_torch.cli recolor --ply ... --out ... --mode single|random|grayscale|sepia
  python -m gsattack_torch.cli combine --plys ... [--scene-dir ...] [--out-ply ...]
  python -m gsattack_torch.cli predict-batch --images-dir ... [--detector ...]
  python -m gsattack_torch.cli asr --benign-log ... --adv-log ... --target car
  python -m gsattack_torch.cli coco-ap --log ... --target-class car

Every command that builds tensors takes `--device` (default `cuda`), and
raises when no card is present unless `--device cpu` is given. The
renders run on the blend's CUDA kernels on a card. `use_mesh=true` (the
multi-device attack and trainer) is not ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np

from .device import resolve_device
from .utils.config import load_config

_MESH = "ROADMAP.md Queue 1 item 13, multi-GPU"


def _parser(prog: str, device: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog)
    if device:
        ap.add_argument("--device", default="cuda",
                        help="torch device; without a card only 'cpu' runs")
    return ap


def _config_parser(prog: str) -> argparse.ArgumentParser:
    ap = _parser(prog)
    ap.add_argument("--config-dir", default="configs")
    return ap


def _setup_scene_and_views(cfg, device):
    """Scene set-up in the reference's three modes. Returns
    (attacked_scene, frozen_scene_or_None, views, attack_mask)."""
    import torch

    from .core import scene_from_points
    from .core.camera import CameraExtrinsics
    from .core.edit import combine_scene_plys
    from .io import load_scene_info, load_scene_ply, search_max_iteration

    scene_cfg = cfg.scene
    if scene_cfg.get("synthetic"):
        rng = np.random.default_rng(0)
        n = int(scene_cfg.get("n_points", 256))
        pts = rng.normal(size=(n, 3)) * 0.5 + np.array([0.0, 0.0, 3.0])
        cols = rng.uniform(0.1, 0.9, size=(n, 3))
        scene = scene_from_points(pts, cols, max_sh_degree=cfg.sh_degree, device=device)
        scene = scene.replace(active_sh_degree=cfg.sh_degree)
        views = [
            CameraExtrinsics(np.eye(3), np.array([0.0, 0.0, 0.1 * i]), 1.0, 1.0, 128, 128, uid=i)
            for i in range(4)
        ]
        return scene, None, views, None

    info = load_scene_info(
        scene_cfg.source_path,
        images=cfg.images,
        eval_split=cfg.eval,
        white_background=cfg.white_background,
        resolution=cfg.resolution,
        shuffle=cfg.get("shuffle_cams", False),
        cam_indices=list(scene_cfg.get("cam_indices", []) or []),
    )
    views = info.train_cameras

    if cfg.combine_splats:
        # Mode C: merge the target and background PLYs; the target part is
        # attacked, the background is the frozen overlay.
        paths = scene_cfg.get("combine_splats_paths") or [
            os.path.join(scene_cfg.model_path, scene_cfg.target_splat),
            os.path.join(scene_cfg.model_path, scene_cfg.background_splat),
        ]
        combined, masks = combine_scene_plys(paths, max_sh_degree=cfg.sh_degree, device=device)
        target_scene = combined.keep_only(masks[0]).compact()
        frozen = combined.keep_only(~masks[0]).compact()
        return target_scene, frozen, views, None

    # Modes A / B: the trained scene's PLY.
    pc_dir = os.path.join(scene_cfg.model_path, "point_cloud")
    it = search_max_iteration(pc_dir)
    scene = load_scene_ply(
        os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply"),
        max_sh_degree=cfg.sh_degree, device=device,
    )
    mask = None
    if not cfg.no_groups:
        # Mode A, grouped: the classifier and the convex hull pick the object.
        from .core.edit import object_selection_mask

        clf_path = os.path.join(scene_cfg.model_path, "classifier.npz")
        if os.path.exists(clf_path):
            d = np.load(clf_path)
            w, b = d["weight"], d["bias"]
        else:
            g = torch.Generator().manual_seed(0)
            w = (torch.randn((cfg.num_classes, 16), generator=g) * 0.1).numpy()
            b = np.zeros(cfg.num_classes, np.float32)
            logging.warning("no classifier.npz found; using random head")
        mask = object_selection_mask(scene, w, b, list(cfg.selected_obj_ids), threshold=0.5)
        if not cfg.get("grouped_full_scene", False):
            # The reference's removal_setup both ways: the PGD loop and the
            # benign silhouette pass see only the selected object, and the
            # background is the frozen eval overlay. grouped_full_scene=true
            # attacks the full scene under the mask instead.
            return scene.keep_only(mask).compact(), scene.keep_only(~mask).compact(), views, None
    return scene, None, views, mask


def _detector_kwargs(cfg):
    """Detector construction settings from the scene config: the checkpoint
    (`detector_weights`), the class count and the input size."""
    kw = {}
    sc = cfg.scene
    if sc.get("detector_weights"):
        kw["weights"] = sc.detector_weights
    if sc.get("detector_num_classes"):
        kw["num_classes"] = int(sc.detector_num_classes)
    if sc.get("detector_imgsz"):
        kw["imgsz"] = int(sc.detector_imgsz)
    return kw


def _check_no_mesh(cfg) -> None:
    if cfg.get("use_mesh"):
        raise NotImplementedError(f"use_mesh=true shards over a device mesh, not ported ({_MESH})")


def cmd_attack(argv):
    from .attack import AttackConfig, run_dagger
    from .models import load_detector

    ap = _config_parser("gsattack_torch attack")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, overrides=args.overrides)
    _check_no_mesh(cfg)

    detector = load_detector(cfg.scene.detector_name, device=device, **_detector_kwargs(cfg))
    detector.load_model()

    def resolve(label):
        if label is None:
            return None
        try:
            return detector.resolve_label_index(label)
        except ValueError:
            logging.warning("unknown class %r", label)
            return None

    target = resolve(cfg.scene.get("target"))
    untarget = resolve(cfg.scene.get("untarget"))

    scene, frozen, views, mask = _setup_scene_and_views(cfg, device)
    acfg = AttackConfig(
        epsilon=cfg.epsilon,
        alpha=cfg.alpha,
        max_iters=cfg.max_iters,
        batch_mode=cfg.batch_mode,
        batch_size=cfg.batch_size,
        attack_conf_thresh=cfg.attack_conf_thresh,
        is_targeted=bool(cfg.scene.get("is_targeted", True)),
        target=target,
        untarget=untarget,
        attributes=tuple(cfg.get("attack_attributes", ["color"])),
        norm=cfg.get("attack_norm", "l2"),
        add_cams=cfg.add_cams,
        start_cam=cfg.get("start_cam"),
        end_cam=cfg.get("end_cam"),
        shift_amount=cfg.shift_amount,
        white_background=cfg.white_background,
        eval_every=cfg.get("eval_every", 1),
        scene_name=cfg.scene.name,
        detector_name=cfg.scene.detector_name,
        output_dir=cfg.splat_asset_path,
        preds_dir="preds" if cfg.write_images else None,
        pairs_per_gaussian=cfg.get("pairs_per_gaussian", 32),
        max_chunks=cfg.get("max_chunks", 16),
        backend=cfg.get("backend", "xla"),
        pairs_budget=cfg.get("pairs_budget", 0),
        rect_candidates=cfg.get("rect_candidates", 0),
        compact_budget=cfg.get("compact_budget", 0),
        tier_split=cfg.get("tier_split", 0),
        heavy_budget=cfg.get("heavy_budget", 0),
    )
    res = run_dagger(scene, views, detector, acfg, frozen_scene=frozen, attack_mask=mask)
    print(
        f"attack finished: success={res.success} iters={res.iterations} "
        f"final_loss={res.losses[-1] if res.losses else None} "
        f"ply={res.adv_ply_path}"
    )
    return 0 if res.success else 1


def cmd_render_eval(argv):
    from .evals import RenderEvalConfig, run_render_eval
    from .models import load_detector

    ap = _config_parser("gsattack_torch render-eval")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, overrides=args.overrides)

    detector = load_detector(cfg.scene.detector_name, device=device, **_detector_kwargs(cfg))
    detector.load_model()
    target = cfg.scene.get("target")
    target_idx = detector.resolve_label_index(target) if target else None
    scene, frozen, views, _ = _setup_scene_and_views(cfg, device)

    logger = logging.getLogger("render")
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    rcfg = RenderEvalConfig(
        target=target_idx,
        untarget=None,
        is_targeted=bool(cfg.scene.get("is_targeted", True)),
        attack_conf_thresh=cfg.attack_conf_thresh,
        white_background=cfg.white_background,
        save_images=cfg.write_images,
        backend=cfg.get("backend", "auto"),
        pairs_per_gaussian=cfg.get("pairs_per_gaussian", -1),
        rect_candidates=cfg.get("rect_candidates", -1),
        pairs_budget=cfg.get("pairs_budget", -1),
        max_chunks=cfg.get("max_chunks", 16),
    )
    out = run_render_eval(scene, views, detector, rcfg, frozen_scene=frozen, logger=logger)
    print(f"rendered {len(out['records'])} cameras -> {out['dirs']}")
    return 0


def cmd_sweep(argv):
    """Hydra's multirun: overrides with comma-separated values sweep their
    cartesian product, each combination running in its own
    `multirun/<date>/<time>/<cam_path>_<target_splat>_<detector>` directory
    (the layout the ASR and AP analyzers sweep over) with a `render.log`
    capture, and the job's working directory set there."""
    import itertools
    from datetime import datetime

    ap = _config_parser("gsattack_torch sweep")
    ap.add_argument("--job", default="render-eval", choices=["render-eval", "attack"])
    ap.add_argument("--sweep-dir", default=None, help="default: multirun/<Y-m-d>/<H-M-S>")
    ap.add_argument("--subdir-fmt", default="{cam_path}_{target_splat}_{detector_name}")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    resolve_device(args.device)
    config_dir = os.path.abspath(args.config_dir)

    fixed, swept = [], []
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        vals = val.split(",")
        (swept if len(vals) > 1 else fixed).append((key, vals if len(vals) > 1 else val))
    combos = [
        [f"{k}={v}" for (k, _), v in zip(swept, choice)]
        for choice in itertools.product(*(vals for _, vals in swept))
    ] if swept else [[]]
    fixed_ov = [f"{k}={v}" for k, v in fixed]

    now = datetime.now()
    root = os.path.abspath(
        args.sweep_dir
        or os.path.join("multirun", now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    )
    job = cmd_render_eval if args.job == "render-eval" else cmd_attack
    cwd, statuses = os.getcwd(), []
    for i, combo in enumerate(combos):
        overrides = fixed_ov + combo
        cfg = load_config(config_dir, overrides=overrides)
        sub = args.subdir_fmt.format(
            cam_path=cfg.get("cam_path", "cams"),
            target_splat=cfg.scene.get("target_splat", cfg.scene.name),
            detector_name=cfg.scene.detector_name,
            scene=cfg.scene.name,
            i=i,
        )
        run_dir = os.path.join(root, sub)
        if os.path.exists(run_dir):  # the pattern collides: add the job index
            run_dir = os.path.join(root, f"{sub}_{i}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "overrides.yaml"), "w") as f:
            f.write("\n".join(f"- {o}" for o in overrides) + "\n")
        fh = logging.FileHandler(os.path.join(run_dir, "render.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
        root_log = logging.getLogger()
        prev_level = root_log.level
        # The jobs log at INFO by propagation, and basicConfig inside a job
        # does nothing once a handler exists, so the level is set here.
        root_log.setLevel(logging.INFO)
        root_log.addHandler(fh)
        print(f"[sweep {i + 1}/{len(combos)}] {sub}: {' '.join(combo)}")
        try:
            os.chdir(run_dir)
            rc = job(["--config-dir", config_dir, "--device", args.device, *overrides])
        finally:
            os.chdir(cwd)
            root_log.removeHandler(fh)
            root_log.setLevel(prev_level)
            fh.close()
        statuses.append((sub, rc))
    print(f"sweep done -> {root}")
    for sub, rc in statuses:
        print(f"  {sub}: exit={rc}")
    return max((rc for _, rc in statuses), default=0)


def cmd_asr(argv):
    from .evals import analyze_asr_logs

    ap = _parser("gsattack_torch asr", device=False)
    ap.add_argument("--benign-log", required=True)
    ap.add_argument("--adv-log", required=True)
    ap.add_argument("--target", required=True)
    args = ap.parse_args(argv)
    r = analyze_asr_logs(args.benign_log, args.adv_log, args.target)
    if r is None:
        print("missing logs")
        return 1
    print(f"ASR: {r['successful']}/{r['total']} = {r['asr']:.2%}")
    return 0


def cmd_coco_ap(argv):
    from .evals import build_coco_jsons, run_coco_eval

    ap = _parser("gsattack_torch coco-ap", device=False)
    ap.add_argument("--log", required=True)
    ap.add_argument("--target-class", required=True)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    gt = os.path.join(args.out_dir, "gt_coco.json")
    dt = os.path.join(args.out_dir, "dt_coco.json")
    build_coco_jsons(args.log, args.width, args.height, gt, dt, args.target_class)
    run_coco_eval(gt, dt, iou_thr=args.iou)
    return 0


def cmd_train(argv):
    """3DGS training on the port's `Trainer` (CLOAK poisoning with
    --poison-views). `sh_increase_interval` and `capacity_headroom`, which
    configs/config.yaml does not set, are read when an override gives
    them."""
    from .core import scene_from_points
    from .io import load_scene_info
    from .io.checkpoint import save_scene_iteration
    from .train import TrainConfig, Trainer

    ap = _config_parser("gsattack_torch train")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--poison-views", type=int, nargs="*", default=None)
    ap.add_argument("--poison-target", default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, overrides=args.overrides)
    _check_no_mesh(cfg)

    info = load_scene_info(
        cfg.scene.source_path,
        images=cfg.images,
        eval_split=cfg.eval,
        white_background=cfg.white_background,
        resolution=cfg.resolution,
        shuffle=True,
    )
    missing = [c for c in info.train_cameras if c.image is None]
    if missing:
        raise SystemExit(f"{len(missing)} training cameras have no ground-truth images")
    scene = scene_from_points(info.points, info.colors, max_sh_degree=cfg.sh_degree,
                              device=device)
    tcfg = TrainConfig(
        iterations=cfg.iterations,
        position_lr_init=cfg.position_lr_init,
        position_lr_final=cfg.position_lr_final,
        position_lr_delay_mult=cfg.position_lr_delay_mult,
        position_lr_max_steps=cfg.position_lr_max_steps,
        feature_lr=cfg.feature_lr,
        opacity_lr=cfg.opacity_lr,
        scaling_lr=cfg.scaling_lr,
        rotation_lr=cfg.rotation_lr,
        percent_dense=cfg.percent_dense,
        lambda_dssim=cfg.lambda_dssim,
        densification_interval=cfg.densification_interval,
        opacity_reset_interval=cfg.opacity_reset_interval,
        densify_from_iter=cfg.densify_from_iter,
        densify_until_iter=cfg.densify_until_iter,
        densify_grad_threshold=cfg.densify_grad_threshold,
        white_background=cfg.white_background,
        sh_increase_interval=cfg.get("sh_increase_interval", TrainConfig.sh_increase_interval),
        capacity_headroom=cfg.get("capacity_headroom", TrainConfig.capacity_headroom),
        spatial_lr_scale=info.nerf_normalization["radius"],
        use_reg3d=bool(cfg.get("use_reg3d", False)),
        reg3d_interval=cfg.reg3d_interval,
        reg3d_k=cfg.reg3d_k,
        reg3d_lambda_val=cfg.reg3d_lambda_val,
        reg3d_max_points=cfg.reg3d_max_points,
        reg3d_sample_size=cfg.reg3d_sample_size,
    )
    classifier = None
    if tcfg.use_reg3d:
        clf_path = os.path.join(cfg.scene.model_path, "classifier.npz")
        if os.path.exists(clf_path):
            d = np.load(clf_path)
            classifier = (d["weight"], d["bias"])
        else:
            rng = np.random.default_rng(0)
            classifier = (
                rng.normal(scale=0.1, size=(cfg.num_classes, 16)).astype(np.float32),
                np.zeros(cfg.num_classes, np.float32),
            )
            logging.warning("use_reg3d with no classifier.npz; random head")
    cams = [c.build(device=device) for c in info.train_cameras]
    gts = [c.image for c in info.train_cameras]
    iters = args.iterations or cfg.iterations
    if args.poison_views:
        from .attack.cloak import CloakConfig, run_cloak
        from .models import load_detector

        det = load_detector(cfg.scene.detector_name, device=device, **_detector_kwargs(cfg))
        det.load_model()
        target = det.resolve_label_index(args.poison_target or cfg.scene.target)
        ccfg = CloakConfig(
            target=target, is_targeted=True, poison_view_indices=tuple(args.poison_views),
        )
        final, _ = run_cloak(
            scene, cams, gts, det, ccfg, train_cfg=tcfg, iterations=iters,
            cameras_extent=info.nerf_normalization["radius"], device=device,
        )
    else:
        trainer = Trainer(
            scene, tcfg, cameras_extent=info.nerf_normalization["radius"],
            classifier=classifier, device=device,
        )
        final = trainer.fit(
            cams, gts, iterations=iters,
            log=lambda i, l: (i % 100 == 0) and print(f"iter {i}: loss {l:.5f}"),
        )
    out = save_scene_iteration(final, cfg.scene.model_path or "output/trained", iters)
    print(f"saved {out}")
    return 0


def cmd_grouping_render(argv):
    """Gaussian-Grouping scene eval: RGB, PCA object-feature and predicted
    object renders per camera, and a comparison video when OpenCV is
    present."""
    from .evals import render_grouping_set
    from .io import load_scene_info
    from .io.checkpoint import load_scene_iteration

    ap = _config_parser("gsattack_torch grouping-render")
    ap.add_argument("-m", "--model-path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--num-classes", type=int, default=256)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, overrides=args.overrides)
    scene, it = load_scene_iteration(args.model_path, args.iteration, cfg.sh_degree,
                                     device=device)
    info = load_scene_info(
        cfg.scene.source_path or args.model_path, shuffle=False, resolution=cfg.resolution,
    )
    classifier = None
    clf_path = os.path.join(args.model_path, "classifier.npz")
    if os.path.exists(clf_path):
        d = np.load(clf_path)
        classifier = (d["weight"], d["bias"])
    out_dir = args.out or os.path.join(args.model_path, f"eval_it{it}")
    cams = [c.build(device=device) for c in info.train_cameras]
    gts = [c.image for c in info.train_cameras if c.image is not None] or None
    res = render_grouping_set(scene, cams, out_dir, classifier=classifier, gt_images=gts)
    print(f"rendered {res['num_frames']} frames -> {out_dir} (video: {res['video']})")
    return 0


def cmd_recolor(argv):
    """Splat recolour tool."""
    from .core.edit import recolor_grayscale, recolor_random, recolor_sepia, recolor_single
    from .io import load_scene_ply, save_scene_ply

    ap = _parser("gsattack_torch recolor")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", required=True, choices=["single", "random", "grayscale", "sepia"])
    ap.add_argument("--color", type=float, nargs=3, default=[1.0, 0.0, 0.0])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scene = load_scene_ply(args.ply, device=device)
    if args.mode == "single":
        scene = recolor_single(scene, args.color)
    elif args.mode == "random":
        scene = recolor_random(scene)
    elif args.mode == "grayscale":
        scene = recolor_grayscale(scene)
    else:
        scene = recolor_sepia(scene)
    save_scene_ply(scene, args.out)
    print(f"recolored ({args.mode}) -> {args.out}")
    return 0


def cmd_combine(argv):
    """Combine splat PLYs and render every camera of a scene directory."""
    import torch

    from .core.edit import combine_scene_plys
    from .io import load_scene_info, save_scene_ply
    from .io.png import to_uint8, write_png
    from .render import render

    ap = _parser("gsattack_torch combine")
    ap.add_argument("--plys", nargs="+", required=True)
    ap.add_argument("--scene-dir", default=None, help="camera source dir")
    ap.add_argument("--out-dir", default="renders/combined_splats")
    ap.add_argument("--out-ply", default=None)
    ap.add_argument("--sh-degree", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    combined, _ = combine_scene_plys(args.plys, max_sh_degree=args.sh_degree, device=device)
    print(f"combined {len(args.plys)} plys -> {combined.num_points} splats")
    if args.out_ply:
        save_scene_ply(combined, args.out_ply)
        print(f"wrote {args.out_ply}")
    if args.scene_dir:
        info = load_scene_info(args.scene_dir, shuffle=False)
        os.makedirs(args.out_dir, exist_ok=True)
        bg = torch.zeros(3, device=device)
        for i, ext in enumerate(info.train_cameras):
            with torch.no_grad():
                img = render(combined, ext.build(device=device), bg)["render"]
            write_png(os.path.join(args.out_dir, f"render_{i:04d}.png"), to_uint8(img))
        print(f"rendered {len(info.train_cameras)} views -> {args.out_dir}")
    return 0


def cmd_predict_batch(argv):
    """Batch detector prediction over an image directory; the annotated
    images are drawn by Pillow."""
    from .io.dataset import read_image
    from .models import load_detector

    ap = _parser("gsattack_torch predict-batch")
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--detector", default="toy")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--out-dir", default="preds")
    args = ap.parse_args(argv)
    det = load_detector(args.detector, device=resolve_device(args.device))
    det.load_model()
    n = 0
    for name in sorted(os.listdir(args.images_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = read_image(os.path.join(args.images_dir, name), "RGB").astype(np.float32) / 255.0
        det.predict_and_save(image=img, path=os.path.join(args.out_dir, name),
                             threshold=args.threshold)
        n += 1
    print(f"predicted {n} images -> {args.out_dir}")
    return 0


COMMANDS = {
    "attack": cmd_attack,
    "render-eval": cmd_render_eval,
    "sweep": cmd_sweep,
    "train": cmd_train,
    "grouping-render": cmd_grouping_render,
    "recolor": cmd_recolor,
    "combine": cmd_combine,
    "predict-batch": cmd_predict_batch,
    "asr": cmd_asr,
    "coco-ap": cmd_coco_ap,
}


def main(argv: Optional[list] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; known: {', '.join(COMMANDS)}")
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
