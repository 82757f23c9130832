"""The 3DGS training cell: `Trainer.fit` over the configuration's schedule,
from a 3-NN initial scene towards ground-truth renders of a target scene,
started again from the set-up's initial state whenever it ends.

Set-up builds the trainer and drives it through its first three steps by
`fit` itself (their losses from its log callback, the first step's
gradient from Adam's first moment after it, the parameters and the densify
statistics after the third); the window continues the same trainer from
step four. Counted: steps, from `fit`'s log callback, which runs after each
step has brought its loss to the host (the program's own synchronise). The
window closes at the first step past `--seconds` and ends in a synchronise.

Checked besides: the window's first densify and prune pass and its first
opacity reset, each from the state the program held just before it (kept
by reference, with no copy and no synchronise in the window) against the
reference's pass from that same state. The reference cannot reach step
100 of its own: it follows the program there, as the DAGGER cell does.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from .. import compare, inputs
from ..reference import render as R
from ..reference import steps as S
from .dagger import WindowClosed

CHECKED_STEPS = 3


class Cell:
    """One run of the cell: the constructor sets up (the problem from the
    seed, the trainer and its first three steps); then `window`,
    `release`, `reference` and `numbers`, as `run.py` calls them."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, workload["traffic"], seed, device
        self.limits = workload["correct"]
        from gsattack_torch.train import Trainer, TrainConfig

        prob = self.problem(device)
        tc = config["train"]
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        cfg = TrainConfig(**{k: v for k, v in tc.items() if k in fields},
                          spatial_lr_scale=prob["extent"],
                          densify_grad_threshold=tc["densify_grad_threshold_ndc"] * 2.0
                          / config["scene"]["width"])
        self.cams = [inputs.program_extrinsics(Rm, T, config["scene"]).build(device=device)
                     for Rm, T in prob["train_views"]]
        self.gts = prob["gts"]
        scene = inputs.program_scene(prob["init"], 0, config["scene"]["sh_degree"])
        self.trainer = Trainer(scene, cfg, prob["extent"], device=device)
        self.initial = _copy_state(self.trainer.state)
        losses, first = [], {}

        def log(it, loss):
            losses.append(loss)
            if it == 1:
                first.update({k: v.detach().clone() for k, v in self.trainer.state.mu.items()})

        self.trainer.fit(self.cams, self.gts, iterations=CHECKED_STEPS, seed=seed, log=log)
        b1 = 0.9  # Adam's first moment after one step is (1 - b1) g
        st = self.trainer.state
        self.taken = {"losses": losses,
                      "grads": {k: v / (1 - b1) for k, v in first.items()},
                      "params": {k: v.detach().clone() for k, v in st.scene.params().items()},
                      "stats": {k: v.clone() for k, v in zip(S.STAT_NAMES, st.stats)}}
        self.densify_threshold = cfg.densify_grad_threshold
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def problem(self, device) -> dict:
        """The target scene, its views and ground-truth renders (by the
        reference renderer), and the initial scene: the target's centres
        moved by N(0, noise^2), the target's DC colours, 3-NN scales."""
        sc, t = self.config["scene"], self.traffic
        target = inputs.synthetic_scene(sc, self.seed, device)
        views = inputs.orbit_views({"camera_T": sc["camera_T"], "views": t["views"],
                                    "yaw_step_deg": t["yaw_step_deg"]})
        cams = inputs.reference_cameras(views, sc, device)
        tr = self.config["train"]
        with torch.no_grad():
            gts = [R.render_views(target, [c], torch.zeros(3, device=device),
                                  tr["pairs_per_gaussian"], tr["chunk"] * tr["max_chunks"],
                                  sc["sh_degree"])["render"][0].contiguous() for c in cams]
        noise = torch.randn(target["xyz"].shape, generator=inputs.generator(self.seed, 4, device),
                            device=device) * sc["point_noise"]
        colors = (target["f_dc"][:, 0] * R.SH_C0 + 0.5).clamp(0, 1)
        init = inputs.point_cloud_scene(target["xyz"] + noise, colors, sc["sh_degree"],
                                        self.seed)
        keep = [i for i in range(t["views"]) if i not in t["held_out"]]
        from ..reference.camera import nerfpp_radius

        return {"init": init, "extent": nerfpp_radius(views),
                "train_views": [views[i] for i in keep], "ref_cams": [cams[i] for i in keep],
                "gts": [gts[i] for i in keep]}

    def window(self, seconds: float, on_unit=None) -> dict:
        stamps, failed = [], 0
        iterations = self.config["train"]["iterations"]
        trainer, stages, sizes = self.trainer, {}, []

        def kept(stage, step):
            """`step` (a schedule of `fit`), keeping the first pass that
            changes the state: the states before and after, by reference."""
            def wrapped(it, *a, **k):
                before = trainer.state
                step(it, *a, **k)
                if trainer.state is not before:
                    stages.setdefault(stage, {"it": it, "before": before,
                                              "after": trainer.state})
                    if stage == "densify":
                        scene = trainer.state.scene
                        sizes.append((it, scene.alive.sum(), scene.num_points))
            return wrapped

        def log(it, loss):
            nonlocal failed
            stamps.append(time.perf_counter())
            if on_unit:
                on_unit()
            failed += not math.isfinite(loss)
            if stamps[-1] >= deadline:
                raise WindowClosed

        trainer.maybe_densify = kept("densify", trainer.maybe_densify)
        trainer.maybe_reset_opacity = kept("reset", trainer.maybe_reset_opacity)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        restarts = 0
        try:
            while True:
                trainer.fit(self.cams, self.gts, iterations=iterations, seed=self.seed, log=log)
                trainer.set_full_state(_copy_state(self.initial))
                restarts += 1
        except WindowClosed:
            pass
        finally:
            del trainer.maybe_densify, trainer.maybe_reset_opacity
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.stages = stages
        self.sizes = [(it, int(n), c) for it, n, c in sizes]
        return {"units": len(stamps), "seconds": elapsed, "attempted": len(stamps),
                "failed": failed, "restarts": restarts, "stamps": [t0] + stamps}

    def end_to_end(self, res: dict) -> dict:
        return {"train_it_s": res["units"] / res["seconds"],
                "train_step_p95_ms": step_p95_ms(res["stamps"])}

    def release(self) -> None:
        self.taken = {"losses": self.taken["losses"],
                      **{k: {n: t.cpu() for n, t in self.taken[k].items()}
                         for k in ("grads", "params", "stats")}}
        for stage, kept in getattr(self, "stages", {}).items():
            self.taken[stage] = {"it": kept["it"], "before": _host_state(kept["before"]),
                                 "after": _host_state(kept["after"])}
        if getattr(self, "sizes", None):
            print("portbench: live splats / capacity after each densify in the window: "
                  + ", ".join(f"step {it} {n}/{c}" for it, n, c in self.sizes), file=sys.stderr)
        self.stages = self.sizes = None
        del self.trainer, self.initial, self.cams, self.gts
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The reference's first three steps from inputs made anew; with
        `control`, in the configuration's lower precision, and as a
        `record` to judge in the program's place against the reference
        computed without `control`."""
        prob = self.problem(self.device)
        tc = self.config["train"]
        capacity = int(prob["init"]["xyz"].shape[0] * tc["capacity_headroom"])
        scene = inputs.pad_scene(prob["init"], capacity)
        train = {**tc, "sh_degree": 0}
        with compare.precision(self.config["control"] if control else None):
            out = S.train_steps(scene, prob["ref_cams"], prob["gts"], train, prob["extent"],
                                self.seed, CHECKED_STEPS)
        out["originals"] = {k: scene[k] for k in R.PARAM_NAMES}
        out["extent"] = prob["extent"]
        if control:
            out["record"] = {k: out[k] for k in ("losses", "grads", "params", "stats")}
            # The passes that follow the program's state: the reference's,
            # in the control's precision, from the same states.
            for stage in ("densify", "reset"):
                if stage in self.taken:
                    with compare.precision(self.config["control"]):
                        after = self.stage_reference(stage, self.taken[stage], out["extent"])
                    out["record"][stage] = {**self.taken[stage], "after": after}
        return out

    def stage_reference(self, stage: str, kept: dict, extent: float) -> dict:
        """The reference's densify pass or opacity reset from the state the
        program held before it. The split draws are made as `fit` makes
        them: the first draw of a device generator seeded by the seed at
        the window's first `fit` call, (2, capacity, 3) N(0, 1)."""
        if stage == "reset":
            return S.reset_opacity(kept["before"])
        tc = self.config["train"]
        capacity = kept["before"]["alive"].shape[0]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        noise = torch.randn((S.N_SPLIT, capacity, 3), generator=gen, device=self.device).cpu()
        train = {**tc, "densify_grad_threshold": self.densify_threshold}
        out = S.densify(kept["before"], train, extent, noise,
                        screen_limit=kept["it"] > tc["opacity_reset_interval"])
        print(f"portbench: densify at step {kept['it']}: {out['made']}", file=sys.stderr)
        return out

    def numbers(self, ref: dict) -> list:
        taken, lim = self.taken, self.limits
        leaves = compare.counted_leaves(ref["grads"])
        out = [("loss_gap", compare.loss_gap(taken["losses"], ref["losses"]), lim["loss_gap"]),
               ("grad1_gap", compare.norm_gap(taken["grads"], ref["grads"], leaves),
                lim["grad1_gap"])]
        ref_change = compare.change(ref["params"], ref["originals"], leaves)
        prog_change = compare.change(taken["params"], ref["originals"], leaves)
        out.append(("change3_gap", compare.norm_gap(prog_change, ref_change, leaves),
                    lim["change3_gap"]))
        out.append(("stats3_gap", compare.diff_gap(taken["stats"], ref["stats"]),
                    lim["stats3_gap"]))
        for stage in ("densify", "reset"):
            if stage not in taken:  # the window ended before the pass
                out += [(f"{stage}_count_gap", math.inf, lim[f"{stage}_count_gap"]),
                        (f"{stage}_gap", math.inf, lim[f"{stage}_gap"])]
                continue
            kept = taken[stage]
            want = self.stage_reference(stage, kept, ref["extent"])
            got = _live(kept["after"])
            count = abs(got["count"] - want["count"]) + abs(got["capacity"] - want["capacity"])
            gap = max(compare.set_gap(got[m], want[m]) for m in ("params", "mu", "nu"))
            out += [(f"{stage}_count_gap", float(count), lim[f"{stage}_count_gap"]),
                    (f"{stage}_gap", gap, lim[f"{stage}_gap"])]
        return out

    def trace_context(self, ref: dict) -> dict:
        return {}


def step_p95_ms(stamps: list) -> float:
    """The 95th percentile of every step's time in the window, in ms
    (`stamps`: the window's start, then each step's end; each step ends in
    the program's own synchronise, so each gap is one step)."""
    import statistics

    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    if len(gaps) < 2:
        return gaps[0] if gaps else math.inf
    return statistics.quantiles(gaps, n=20)[-1]


def _live(after: dict) -> dict:
    """The live splats of a state after a pass, as the reference gives
    them: a program's state (slots and an `alive` mask) is masked; the
    control's, the reference's own, is already so."""
    if "alive" not in after:
        return after
    alive = after["alive"]
    return {**{m: {k: v[alive] for k, v in after[m].items()} for m in ("params", "mu", "nu")},
            "count": int(alive.sum()), "capacity": alive.shape[0]}


def _host_state(st) -> dict:
    """What the reference reads of a trainer state, on the host."""
    return {"params": {k: v.detach().cpu() for k, v in st.scene.params().items()},
            "alive": st.scene.alive.cpu(),
            "mu": {k: v.cpu() for k, v in st.mu.items()},
            "nu": {k: v.cpu() for k, v in st.nu.items()},
            "stats": {k: v.cpu() for k, v in zip(S.STAT_NAMES, st.stats)}}


def _copy_state(st):
    """A copy of a trainer state whose tensors the trainer cannot touch."""
    return dataclasses.replace(
        st, scene=st.scene.with_params({k: v.clone() for k, v in st.scene.params().items()}),
        mu={k: v.clone() for k, v in st.mu.items()}, nu={k: v.clone() for k, v in st.nu.items()},
        stats=type(st.stats)(*(v.clone() for v in st.stats)))
