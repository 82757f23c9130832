"""Faults planted in the program's timed path, to show that the check of
`correct` catches them: a step that returns its state unchanged, half of
the batch left out (the mean over the rest), an answer altered where it is
produced; for training besides, densify's children and the opacity reset's
opacities altered where they are written. Each is a patch of the program's module attributes, applied by
`plant(kind, fault, setattr)` with a `setattr` that the caller undoes
(pytest's monkeypatch, or `Patches`)."""

from __future__ import annotations

import torch

COMMON = ("unchanged_step", "half_batch", "altered_answer")
FAULTS = {"dagger": COMMON, "train": COMMON + ("densify_altered", "reset_altered")}


class Patches:
    """A setattr that remembers what it replaced; `undo()` puts it back."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def plant(kind: str, fault: str, setattr_) -> None:
    if kind == "dagger":
        _dagger(fault, setattr_)
    else:
        _train(fault, setattr_)


def _dagger(fault: str, setattr_) -> None:
    from gsattack_torch.attack import dagger
    from gsattack_torch.models.frcnn import FasterRCNNDetector

    if fault == "unchanged_step":
        setattr_(dagger, "pgd_attack_step", lambda scene, *a, **k: scene)
    elif fault == "half_batch":
        loss = FasterRCNNDetector.loss

        def half(self, images, target, bboxes):
            b = images.shape[0] // 2
            return loss(self, images[:b], target, bboxes[:b])

        setattr_(FasterRCNNDetector, "loss", half)
    elif fault == "altered_answer":
        render = dagger.render_views

        def altered(*a, **k):
            img = render(*a, **k)
            return torch.cat([img[:1] + 0.05, img[1:]])

        setattr_(dagger, "render_views", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _train(fault: str, setattr_) -> None:
    from gsattack_torch.train import trainer

    if fault == "unchanged_step":
        adam = trainer.adam_update

        def unchanged(params, grads, mu, nu, count, lrs):
            _, mu, nu, count = adam(params, grads, mu, nu, count, lrs)
            return dict(params), mu, nu, count

        setattr_(trainer, "adam_update", unchanged)
    elif fault == "half_batch":
        loss = trainer.dssim_l1_loss

        def half(pred, gt, lam):
            h = pred.shape[0] // 2
            return loss(pred[:h], gt[:h], lam)

        setattr_(trainer, "dssim_l1_loss", half)
    elif fault == "altered_answer":
        render = trainer.render

        def altered(*a, **k):
            out = render(*a, **k)
            return {**out, "render": out["render"] + 0.05}

        setattr_(trainer, "render", altered)
    elif fault == "densify_altered":
        from gsattack_torch.train import densify

        scatter = densify._scatter_children

        def altered_children(params, alive, want, child):
            return scatter(params, alive, want, {**child, "log_scale": child["log_scale"] + 0.1})

        setattr_(densify, "_scatter_children", altered_children)
    elif fault == "reset_altered":
        reset = trainer.reset_opacity

        def altered_reset(scene):
            out = reset(scene)
            return out.replace(opacity_logit=out.opacity_logit + 0.1)

        setattr_(trainer, "reset_opacity", altered_reset)
    else:
        raise ValueError(f"unknown fault {fault!r}")
