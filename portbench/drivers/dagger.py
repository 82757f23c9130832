"""The DAGGER cell: one `run_dagger` attack of a batch of views against a
detector, started when the window opens, so that the attack's own set-up
(the cap probe, the benign silhouette pass) is paid as a user pays it, and
started again from the same scene whenever it ends inside the window.

Counted: PGD iterations whose success check (eval render and detector
predictions, `eval_every` 1) has finished. The window closes at the first
such iteration past `--seconds`: the harness's log callback raises, and the
window ends in a synchronise. The program synchronises each iteration
itself: the loss goes to the host for the log line, the eval images for
the success check.

Checked: the window's first three PGD steps (their losses from the log
lines, their loss-render images, the first step's gradients as
`pgd_attack_step` gets them, the scene after each step), step by step
against the reference from the same state: its render of that state
judges the images, its detector's loss on those images judges the loss,
its gradient through its own render judges the gradients, its l2 step
judges each step's change, direction and length. The reference's detector
reads the program's images because Faster R-CNN's discrete choices
(proposal ranks, ROI labels at IoU 0.5) flip on rounding-level differences
between two renders.
"""

from __future__ import annotations

import dataclasses
import math
import tempfile
import time

import torch

from .. import compare, inputs, work
from ..reference import render as R
from ..reference import steps as S
from ..reference.frcnn import ReferenceFasterRCNN

CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised from the attack's log callback to stop it when time is up."""


class Cell:
    """One run of the cell: the constructor sets up (inputs from the seed,
    the program's detector and attack, a warm-up attack); then `window`,
    `release`, `reference` and `numbers`, as `run.py` calls them."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, workload["traffic"], seed, device
        self.limits = workload["correct"]
        from gsattack_torch.attack import AttackConfig
        from gsattack_torch.models import load_detector

        scene = inputs.synthetic_scene(config["scene"], seed, device)
        deg = config["scene"]["sh_degree"]
        self.scene = inputs.program_scene(scene, deg, deg)
        R0, T = inputs.orbit_views(self.view_spec())[0]
        self.ext = inputs.program_extrinsics(R0, T, config["scene"])
        det = config["detector"]
        self.detector = load_detector(det["name"], num_classes=det["num_classes"],
                                      num_proposals=det["num_proposals"], device=device)
        inputs.detector_weights(self.detector.model, seed, device)
        self.out_dir = tempfile.TemporaryDirectory(prefix="portbench-")
        a = config["attack"]
        self.cfg = AttackConfig(
            epsilon=a["epsilon"], alpha=a["alpha"], max_iters=a["max_iters"],
            batch_size=self.traffic["batch_size"], add_cams=self.traffic["views"],
            target=a["target"], attributes=tuple(a["attributes"]), norm=a["norm"],
            eval_every=a["eval_every"], attack_conf_thresh=a["attack_conf_thresh"],
            pairs_per_gaussian=a["pairs_per_gaussian"], chunk=a["chunk"],
            max_chunks=a["max_chunks"], backend=a["backend"], output_dir=self.out_dir.name,
            detector_name=det["name"],
        )
        # Warm-up: a two-iteration attack on the same shapes (the per-batch
        # budget of three ends it after two).
        self.attack(dataclasses.replace(self.cfg, max_iters=3), lambda line: None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def view_spec(self) -> dict:
        return {"camera_T": self.config["scene"]["camera_T"], "views": self.traffic["views"],
                "yaw_step_deg": self.traffic["yaw_step_deg"]}

    def attack(self, cfg, log):
        from gsattack_torch.attack import run_dagger

        return run_dagger(self.scene, [self.ext], self.detector, cfg, log=log)

    def window(self, seconds: float, on_unit=None) -> dict:
        from gsattack_torch.attack import dagger

        losses, images, states, iters, failed, attacks = [], [], [None], 0, 0, 0
        grads = {}
        step, render = dagger.pgd_attack_step, dagger.render_views

        def recording_render(*args, **kwargs):
            img = render(*args, **kwargs)
            if torch.is_grad_enabled() and len(images) < CHECKED_STEPS:
                images.append(img.detach())  # a loss render (the eval render has no grad)
            return img

        def recording_step(*args, **kwargs):
            out = step(*args, **kwargs)
            if len(states) <= CHECKED_STEPS:
                grads.update(args[1] if len(states) == 1 else {})
                states.append(out.params())
            return out

        def log(line: str):
            nonlocal iters, failed
            if line.startswith("Iteration:"):
                loss = float(line.rsplit("Loss:", 1)[1])
                failed += not math.isfinite(loss)
                if attacks == 0 and len(losses) < CHECKED_STEPS:
                    losses.append(loss)
            elif line.startswith("Successes:"):
                iters += 1
                if on_unit:
                    on_unit()
                if time.perf_counter() >= deadline:
                    raise WindowClosed

        dagger.pgd_attack_step, dagger.render_views = recording_step, recording_render
        t0 = time.perf_counter()
        deadline = t0 + seconds
        try:
            while True:
                self.attack(self.cfg, log)
                attacks += 1
        except WindowClosed:
            pass
        finally:
            dagger.pgd_attack_step, dagger.render_views = step, render
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.taken = {"losses": losses, "images": images, "grads": grads or None,
                      "states": states}
        return {"units": iters, "seconds": elapsed, "attempted": iters, "failed": failed,
                "restarts": attacks}

    def end_to_end(self, res: dict) -> dict:
        return {"pgd_it_s": res["units"] / res["seconds"]}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.taken = _to_cpu(self.taken)
        del self.scene, self.detector
        self.out_dir.cleanup()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The reference's inputs made anew from the seed (scene, cameras,
        detector, the attack's pair capacity and GT boxes); with `control`,
        also the reference's own run in the configuration's lower precision
        (`record`, judged in the program's place)."""
        dev = self.device
        scene = inputs.synthetic_scene(self.config["scene"], self.seed, dev)
        spec = {**self.config["scene"], **self.view_spec()}
        cams = inputs.reference_cameras(inputs.orbit_views(spec), self.config["scene"], dev)
        det = self.config["detector"]
        model = ReferenceFasterRCNN(det["num_classes"], det["num_proposals"]).to(dev)
        model.eval().requires_grad_(False)
        inputs.detector_weights(model.model, self.seed, dev)
        attack = {**self.config["attack"], "sh_degree": self.config["scene"]["sh_degree"]}
        pairs, boxes = S.dagger_setup(scene, cams, attack)
        out = {"scene": scene, "cams": cams, "model": model, "attack": attack,
               "pairs_per_gaussian": pairs, "boxes": boxes}
        if control:
            with compare.precision(self.config["control"]):
                out["record"] = _to_cpu(S.dagger_run(scene, cams, model, attack, CHECKED_STEPS))
        return out

    def numbers(self, ref: dict) -> list:
        """(name, value, limit) of each number compared. The reference
        follows the judged run step by step (`reference/steps.py`): its
        detector reads the judged images, its own render judges them."""
        rec, lim = self.taken, self.limits
        if len(rec["images"]) < CHECKED_STEPS or len(rec["states"]) <= CHECKED_STEPS:
            return [(name, math.inf, limit) for name, limit in lim.items()]
        judge = S.dagger_judge(rec, ref["scene"], ref["cams"], ref["model"], ref["attack"])
        render = max(float((a - b).abs().max()) for a, b in zip(rec["images"], judge["images"]))
        loss = compare.loss_gap(rec["losses"], judge["losses"])
        leaves = compare.counted_leaves(judge["grads"])
        grad = compare.norm_gap(rec["grads"], judge["grads"], leaves)
        step = max(_step_gap(rec["states"][k + 1], rec["states"][k] if k else
                             {n: v.cpu() for n, v in ref["scene"].items()},
                             judge["states"][k], leaves) for k in range(CHECKED_STEPS))
        return [("render_gap", render, lim["render_gap"]), ("loss_gap", loss, lim["loss_gap"]),
                ("grad1_gap", grad, lim["grad1_gap"]), ("step_gap", step, lim["step_gap"])]

    def trace_context(self, ref: dict) -> dict:
        """Per iteration, the blend's least seconds (one loss render's
        forward and backward and one eval render's forward, at the
        reference's binning of this scene and these views) and the FLOPs
        (the detector's loss forward, its image-gradient backward and the
        eval forward of each view, plus the blend's operations)."""
        dev = self.device
        scene, cams, model = ref["scene"], ref["cams"], ref["model"]
        a = self.config["attack"]
        cap = a["chunk"] * a["max_chunks"]
        deg = self.config["scene"]["sh_degree"]
        with torch.no_grad():
            out = R.render_views(scene, cams, torch.zeros(3, device=dev),
                                 ref["pairs_per_gaussian"], cap, deg)
            projs = out["projs"]
            blend_in = [torch.stack([p[k] for p in projs])
                        for k in ("mean2d", "conic", "opacity", "channels")]
            w = work.pair_work(out["bins"], blend_in, out["tiles"], cap, out["last"])
        v, n, ch = blend_in[3].shape
        b = work.blend_bounds(out["bins"][0].shape[0], v, n, ch,
                              out["tiles"][0] * out["tiles"][1], out["last"].numel(),
                              ref["pairs_per_gaussian"], w)
        imgs = out["render"].detach().clone().requires_grad_(True)

        def detector_work():
            loss = model.loss(imgs, a["target"], ref["boxes"])
            loss.backward()
            for i in range(v):
                model.eval_forward(imgs[i:i + 1].detach())

        flops = work.flops_of(detector_work) + 2 * b["fwd_ops"] + b["bwd_ops"] + b["sum_ops"]
        return {"blend_bound_s": 2 * b["fwd"] + b["bwd"] + b["sum"], "flops": flops,
                "pixel_pairs": w}


def _step_gap(after: dict, before: dict, ref_after: dict, leaves: list) -> float:
    """One step's change, the judged run's against the reference's from the
    same state: over the leaves the reference moves, the worst
    ‖change - reference's change‖ over ‖reference's change‖. An l2 step
    moves each leaf by alpha whatever its gradient's direction, so a gap of
    norms alone would not see a wrong gradient; this sees it. Inf where the
    judged run moves a leaf the reference leaves."""
    ref_change = compare.change(ref_after, before, leaves)
    change = compare.change(after, before, leaves)
    moved = compare.moved_leaves(ref_change, leaves)
    if any(float(change[k].abs().max()) > 0 for k in leaves if k not in moved):
        return math.inf
    if not moved:
        return math.inf
    return compare.diff_gap({k: change[k] for k in moved}, {k: ref_change[k] for k in moved})


def _to_cpu(v):
    """Every tensor in `v` (nested in lists and dicts) on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_cpu(t) for k, t in v.items()}
    if isinstance(v, list):
        return [_to_cpu(t) for t in v]
    return v
