"""`gsattack_torch.cli` against `gsattack.cli`, and the port's workflow
chain on the CPU (`--device cpu`).

The JAX CLI runs three expensive commands here (attack, render-eval and a
two-run sweep), each package's `load_detector` returning a seeded toy head
and its carried-across twin. The cheap commands (recolor, combine, asr,
coco-ap) are compared file for file. The chain is a copy of
`tests/test_workflow_e2e.py`'s through the port alone: train -> attack
with the crafted YOLOv8 checkpoint -> render-eval on the benign and the
adversarial scene -> asr, then grouping-render, combine and predict-batch
on what it made."""

import logging
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import gsattack.cli as jcli
import gsattack.models as jmodels
import gsattack_torch.cli as tcli
import gsattack_torch.core as tcore
import gsattack_torch.core.edit as tedit
import gsattack_torch.models as tmodels
from gsattack.core import sh as jsh
from gsattack.evals import load_preds as j_load_preds
from gsattack.io.ply import read_ply_vertex_table as j_read_table
from gsattack.io import save_scene_ply as j_save_ply
from gsattack.models import ToyDetector as JToy
from gsattack_torch.convert import toy_detector_from_numpy
from gsattack_torch.io import load_scene_ply, read_ply_vertex_table
from gsattack_torch.io.png import read_png
from tests.conftest import make_toy_scene
from tests.test_torch_evals import compare_records, log_records

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def toy_twins(monkeypatch):
    """Both CLIs get the same seeded toy head; the port's synthetic scene
    gets the JAX package's random object features."""
    jdet = JToy(num_classes=80, seed=4)
    jdet.load_model()
    tdet = toy_detector_from_numpy({k: np.asarray(v) for k, v in jdet.params.items()}, 80, 16,
                                   device="cpu")
    monkeypatch.setattr(jmodels, "load_detector", lambda name, **kw: jdet)
    monkeypatch.setattr(tmodels, "load_detector", lambda name, **kw: tdet)
    made = tcore.scene_from_points

    def with_jax_objects(points, colors, max_sh_degree=3, **kw):
        sc = made(points, colors, max_sh_degree=max_sh_degree, **kw)
        obj = jsh.rgb_to_sh(jax.random.uniform(jax.random.PRNGKey(0), (len(points), 16)))
        return sc.replace(obj_dc=torch.tensor(np.asarray(obj))[:, None, :].to(sc.device))

    monkeypatch.setattr(tcore, "scene_from_points", with_jax_objects)
    monkeypatch.chdir(REPO)


def _with_render_log(path, fn):
    """fn() with a file handler on the `render` logger, as the JAX
    workflow test captures a render-eval run."""
    log = logging.getLogger("render")
    log.setLevel(logging.INFO)  # pytest sets the root to WARNING
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    log.addHandler(fh)
    try:
        return fn()
    finally:
        log.removeHandler(fh)
        fh.close()


def test_cli_attack_matches_jax(tmp_path, toy_twins):
    """Untargeted with no class to avoid: every evaluated batch succeeds,
    so two PGD steps (two batches of two views) write the adversarial PLY."""
    ov = ["max_iters=3", "batch_mode=true", "batch_size=2", "eval_every=1",
          "scene.is_targeted=false", "scene.untarget=null", "attack_norm=l2"]
    rc_j = jcli.main(["attack", *ov, f"splat_asset_path={tmp_path / 'j'}"])
    rc_t = tcli.main(["attack", *ov, f"splat_asset_path={tmp_path / 't'}", *CPU])
    assert rc_t == rc_j == 0
    want = j_read_table(str(tmp_path / "j" / "toy_adv_toy.ply"))
    got = read_ply_vertex_table(str(tmp_path / "t" / "toy_adv_toy.ply"))
    assert list(got) == list(want)
    g, w = (np.stack([t[k] for k in want], 1) for t in (got, want))
    assert np.abs(g - w).max() / np.abs(w).max() <= 1e-4
    # The attack moved the colours of the synthetic scene (seed 0).
    rng = np.random.default_rng(0)
    rng.normal(size=(256, 3))
    f_dc0 = jsh.rgb_to_sh(rng.uniform(0.1, 0.9, size=(256, 3)))
    f_dc = np.stack([got[f"f_dc_{i}"] for i in range(3)], 1)
    assert np.abs(f_dc - f_dc0).max() > 1e-3


def test_cli_render_eval_matches_jax(tmp_path, toy_twins):
    ov = ["write_images=false", "attack_conf_thresh=0.05"]
    logs = {k: str(tmp_path / f"{k}.log") for k in "jt"}
    rc_j = _with_render_log(logs["j"], lambda: jcli.main(["render-eval", *ov]))
    rc_t = _with_render_log(logs["t"], lambda: tcli.main(["render-eval", *ov, *CPU]))
    assert rc_t == rc_j == 0
    compare_records(log_records(logs["t"]), log_records(logs["j"]))
    assert len(log_records(logs["j"])) == 4
    assert j_load_preds(logs["t"]) == j_load_preds(logs["j"])


def test_cli_sweep_matches_jax(tmp_path, toy_twins):
    root_log = logging.getLogger()
    handlers, level, cwd = list(root_log.handlers), root_log.level, os.getcwd()
    args = ["--subdir-fmt", "{detector_name}_{i}", "write_images=false",
            "attack_conf_thresh=0.05,0.5"]
    rc_j = jcli.main(["sweep", "--sweep-dir", str(tmp_path / "j"), *args])
    rc_t = tcli.main(["sweep", "--sweep-dir", str(tmp_path / "t"), *args, *CPU])
    assert rc_t == rc_j == 0
    assert (os.getcwd(), root_log.handlers, root_log.level) == (cwd, handlers, level)
    subs = sorted(os.listdir(tmp_path / "j"))
    assert subs == sorted(os.listdir(tmp_path / "t")) == ["toy_0", "toy_1"]
    for sub in subs:
        j, t = tmp_path / "j" / sub, tmp_path / "t" / sub
        assert (t / "overrides.yaml").read_text() == (j / "overrides.yaml").read_text()
        compare_records(log_records(str(t / "render.log")), log_records(str(j / "render.log")))
    # A failing job leaves the working directory and the root logger as
    # they were.
    with pytest.raises(ValueError, match="scene type"):
        tcli.main(["sweep", "--sweep-dir", str(tmp_path / "bad"), "write_images=false",
                   "scene.synthetic=false", f"scene.source_path={tmp_path / 'none'}", *CPU])
    assert (os.getcwd(), root_log.handlers, root_log.level) == (cwd, handlers, level)


def test_cli_recolor_combine_asr_coco_ap_match_jax(tmp_path, monkeypatch, capsys):
    plys = []
    for i, n in enumerate((30, 18)):
        plys.append(str(tmp_path / f"s{i}.ply"))
        j_save_ply(make_toy_scene(n=n, seed=i + 3), plys[-1])
    recolor_random = tedit.recolor_random
    monkeypatch.setattr(tedit, "recolor_random", lambda sc: recolor_random(
        sc, rgb=np.array(jax.random.uniform(jax.random.PRNGKey(0), (sc.num_points, 1, 3)))))
    for mode in ("single", "random", "grayscale", "sepia"):
        args = ["recolor", "--ply", plys[0], "--mode", mode, "--color", "0.1", "0.7", "0.4"]
        assert jcli.main([*args, "--out", str(tmp_path / f"j_{mode}.ply")]) == 0
        assert tcli.main([*args, "--out", str(tmp_path / f"t_{mode}.ply"), *CPU]) == 0
        assert (tmp_path / f"t_{mode}.ply").read_bytes() == (
            tmp_path / f"j_{mode}.ply").read_bytes(), mode
        rest = load_scene_ply(str(tmp_path / f"t_{mode}.ply"), device="cpu").f_rest
        assert float(rest.abs().max()) == 0.0

    args = ["combine", "--plys", *plys]
    assert jcli.main([*args, "--out-ply", str(tmp_path / "j_comb.ply")]) == 0
    assert tcli.main([*args, "--out-ply", str(tmp_path / "t_comb.ply"), *CPU]) == 0
    assert (tmp_path / "t_comb.ply").read_bytes() == (tmp_path / "j_comb.ply").read_bytes()
    capsys.readouterr()

    from tests.test_torch_evals import _random_entries, _write_log

    bp, ap = str(tmp_path / "b.log"), str(tmp_path / "a.log")
    _write_log(bp, _random_entries(30, 5))
    _write_log(ap, _random_entries(30, 6))
    outs = {}
    for tag, cli in (("j", jcli), ("t", tcli)):
        od = tmp_path / tag
        od.mkdir()
        rcs = (cli.main(["asr", "--benign-log", bp, "--adv-log", ap, "--target", "car"]),
               cli.main(["asr", "--benign-log", bp, "--adv-log", "missing", "--target", "car"]),
               cli.main(["coco-ap", "--log", bp, "--target-class", "car", "--width", "64",
                         "--height", "64", "--out-dir", str(od)]))
        outs[tag] = (rcs, capsys.readouterr().out, (od / "gt_coco.json").read_text(),
                     (od / "dt_coco.json").read_text())
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == (0, 1, 0) and "ASR:" in outs["t"][1]


def test_cli_commands_refusals_and_devices(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert list(tcli.COMMANDS) == list(jcli.COMMANDS)
    assert tcli.main(["bogus"]) == jcli.main(["bogus"]) == 2
    assert tcli.main(["--help"]) == 0 and "coco-ap" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 13"):
        tcli.main(["attack", "use_mesh=true", "max_iters=1", *CPU])
    with pytest.raises(NotImplementedError, match="item 6"):
        tcli.main(["render-eval", "pairs_budget=4096", "write_images=false", *CPU])
    with pytest.raises(NotImplementedError, match="item 6"):
        tcli.main(["attack", "tier_split=8", "max_iters=1", f"splat_asset_path={tmp_path}",
                   *CPU])
    # Without a card, every command that builds tensors raises unless it
    # is given --device cpu.
    missing = str(tmp_path / "missing")
    for argv in (["attack"], ["render-eval"], ["sweep", "--sweep-dir", missing],
                 ["train"], ["grouping-render", "-m", missing],
                 ["recolor", "--ply", missing, "--out", missing, "--mode", "sepia"],
                 ["combine", "--plys", missing], ["predict-batch", "--images-dir", missing]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli.main(argv)
    assert not os.path.exists(missing)


def test_port_workflow_chain(tmp_path, monkeypatch, capsys):
    """`tests/test_workflow_e2e.py`'s chain through `gsattack_torch.cli`
    alone on the CPU (GT images rendered by the port, `use_mesh` off),
    then grouping-render, combine and predict-batch on its outputs."""
    from gsattack.evals import analyze_asr_logs as j_asr
    from gsattack_torch.evals import analyze_asr_logs as t_asr
    from gsattack_torch.io import load_scene_info
    from gsattack_torch.io.png import to_uint8, write_png
    from gsattack_torch.render import render
    from tests.test_workflow_e2e import NC, _write_scene, _yolo_weights

    monkeypatch.chdir(REPO)
    rng = np.random.default_rng(0)
    n = 400
    pts = rng.normal(size=(n, 3)) * np.array([1.0, 0.8, 0.3]) + np.array([0.0, 0.0, 2.5])
    cols = rng.uniform(0.3, 0.95, size=(n, 3))
    cams_rt = [(np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.12 * i])) for i in range(4)]
    src = tmp_path / "scene"
    _write_scene(src, cams_rt, pts, cols)
    target = tcore.scene_from_points(pts, cols, max_sh_degree=0, device="cpu")
    target = target.replace(opacity_logit=torch.full_like(target.opacity_logit, 1.5),
                            log_scale=target.log_scale + 0.7)
    info = load_scene_info(str(src))
    for ext in info.train_cameras:
        with torch.no_grad():
            img = render(target, ext.build(device="cpu"), torch.zeros(3))["render"]
        write_png(str(src / "images" / f"{ext.image_name}.png"), to_uint8(img))

    model_dir = tmp_path / "model"
    common = [f"scene.source_path={src}", f"scene.model_path={model_dir}",
              "scene.synthetic=false", "scene.cam_indices=[]", "sh_degree=0", "resolution=1"]
    assert tcli.main(["train", "--iterations", "120", *common, *CPU]) == 0
    ply = model_dir / "point_cloud" / "iteration_120" / "point_cloud.ply"
    assert load_scene_ply(str(ply), max_sh_degree=0, device="cpu").num_points > 0

    det_over = ["scene.detector_name=yolov8", f"scene.detector_weights={_yolo_weights(tmp_path)}",
                f"scene.detector_num_classes={NC}", "scene.detector_imgsz=64",
                "scene.target=car", "scene.is_targeted=true"]
    assert tcli.main(["attack", "no_groups=true", "combine_splats=false", "max_iters=4",
                      "batch_mode=true", "batch_size=2", "eval_every=1",
                      f"splat_asset_path={tmp_path}", *common, *det_over, *CPU]) == 0
    adv_ply = tmp_path / "toy_adv_yolov8.ply"
    assert adv_ply.exists(), "targeted attack did not succeed / save the PLY"

    adv_model = tmp_path / "adv_model"
    os.makedirs(adv_model / "point_cloud" / "iteration_1")
    shutil.copy(adv_ply, adv_model / "point_cloud" / "iteration_1" / "point_cloud.ply")
    logs = {}
    for tag, mp in (("benign", model_dir), ("adv", adv_model)):
        logs[tag] = str(tmp_path / f"{tag}_render.log")
        rc = _with_render_log(logs[tag], lambda: tcli.main(
            ["render-eval", "no_groups=true", "combine_splats=false", f"scene.model_path={mp}",
             *[o for o in common if "model_path" not in o], *det_over, *CPU]))
        assert rc == 0
        assert len(log_records(logs[tag])) == 4, f"{tag} render.log has no records"
    r = t_asr(logs["benign"], logs["adv"], "car")
    assert r == j_asr(logs["benign"], logs["adv"], "car")
    assert r["total"] > 0, "ASR pipeline measured nothing"
    assert tcli.main(["asr", "--benign-log", logs["benign"], "--adv-log", logs["adv"],
                      "--target", "car"]) == 0

    grp = tmp_path / "grouping"
    assert tcli.main(["grouping-render", "-m", str(model_dir), "--out", str(grp),
                      f"scene.source_path={src}", "sh_degree=0", *CPU]) == 0
    assert sorted(os.listdir(grp / "renders")) == [f"{i:05d}.png" for i in range(4)]
    assert len(os.listdir(grp / "gt")) == 4
    comb = tmp_path / "combined"
    assert tcli.main(["combine", "--plys", str(ply), str(adv_ply), "--scene-dir", str(src),
                      "--out-dir", str(comb), "--sh-degree", "0", *CPU]) == 0
    for i in range(4):
        assert read_png(str(comb / f"render_{i:04d}.png")).shape == (48, 64, 3)
    preds = tmp_path / "preds"
    assert tcli.main(["predict-batch", "--images-dir", str(src / "images"), "--out-dir",
                      str(preds), "--threshold", "0.3", *CPU]) == 0
    assert sorted(os.listdir(preds)) == sorted(os.listdir(src / "images"))
    assert "predicted 4 images" in capsys.readouterr().out
