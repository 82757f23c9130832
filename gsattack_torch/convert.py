"""Weights and state carried across from the JAX package as numpy arrays,
so that both packages can run the same scene, detector and cameras.

The inputs are plain numpy: a `GaussianScene.params()` dict, a training
state's arrays, the toy detector's HWIO weights, a detector's flax
`variables` tree, and a camera's matrices. Every float array is converted to float32 at this
boundary.

The JAX detectors name their flax modules after the upstream torch
modules, with each numeric path token merged onto the one before it
(`model.2.m.0.cv1` is `m2/m_0/cv1`, `cv2.0.2` is `cv2_0_2`). So each entry
of a port detector's state dict names its flax leaf: a conv's 4-D
`weight` is the flax `kernel` in HWIO (I = c_in / groups), a linear's 2-D
`weight` the transposed (in, out) `kernel`, a norm's `weight` / `bias` the
flax `scale` / `bias`, and its `running_mean` / `running_var` the
`batch_stats` `mean` / `var`.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from .core.camera import Camera
from .core.scene import PARAM_NAMES, GaussianScene
from .device import resolve_device
from .models.toy import ToyDetector
from .train.densify import DensifyStats
from .train.trainer import TrainState


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def scene_from_numpy(
    params: Mapping[str, np.ndarray],
    alive: np.ndarray,
    active_sh_degree: int,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """A scene from its parameter arrays (the names of
    `GaussianScene.params()`) and its `alive` mask; the maximum SH degree
    is the one `f_rest` holds."""
    dev = resolve_device(device)
    max_sh_degree = int(round(np.sqrt(np.shape(params["f_rest"])[1] + 1))) - 1
    return GaussianScene(
        **{name: _f32(params[name], dev) for name in PARAM_NAMES},
        alive=torch.tensor(np.asarray(alive, bool), device=dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=max_sh_degree,
    )



def train_state_from_jax(state, device: str | torch.device = "cuda") -> TrainState:
    """A training state holding a JAX `TrainState`'s values: its scene,
    its optax `ScaleByAdamState` (count, mu, nu), its `DensifyStats` and
    its step, each read as numpy."""
    dev = resolve_device(device)
    sc = state.scene
    opt = state.opt_state
    return TrainState(
        scene=scene_from_numpy({k: np.asarray(v) for k, v in sc.params().items()},
                               np.asarray(sc.alive), sc.active_sh_degree, device=dev),
        mu={k: _f32(v, dev) for k, v in opt.mu.items()},
        nu={k: _f32(v, dev) for k, v in opt.nu.items()},
        count=int(np.asarray(opt.count)),
        stats=DensifyStats(*(_f32(v, dev) for v in state.stats)),
        step=int(np.asarray(state.step)),
    )

def toy_detector_from_numpy(
    params: Mapping[str, np.ndarray],
    num_classes: int,
    channels: int,
    device: str | torch.device = "cuda",
) -> ToyDetector:
    """A toy detector holding the given weights: convolution kernels
    w0, w1, w2 and wh in HWIO become OIHW; biases b0, b1, b2 and bh stay."""
    det = ToyDetector(num_classes=num_classes, channels=channels, device=device)
    dev = det.params["w0"].device
    with torch.no_grad():
        for name, value in params.items():
            a = np.asarray(value, np.float32)
            if name.startswith("w"):
                a = a.transpose(3, 2, 0, 1)
            if tuple(det.params[name].shape) != a.shape:
                raise ValueError(f"{name}: shape {a.shape}, want {tuple(det.params[name].shape)}")
            det.params[name].copy_(_f32(a, dev))
    return det


def camera_from_numpy(
    view: np.ndarray,
    full_proj: np.ndarray,
    cam_center: np.ndarray,
    tanfovx: float,
    tanfovy: float,
    width: int,
    height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """A camera from its world->camera and full projection matrices
    (column-vector convention), centre and tan half-FoVs."""
    dev = resolve_device(device)
    return Camera(
        view=_f32(view, dev),
        full_proj=_f32(full_proj, dev),
        cam_center=_f32(cam_center, dev),
        tanfovx=_f32(tanfovx, dev),
        tanfovy=_f32(tanfovy, dev),
        width=int(width),
        height=int(height),
    )


# ---------------------------------------------------------------------------
# Detectors: flax variables -> the port module's state dict
# ---------------------------------------------------------------------------

_NORM_LEAVES = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def _merge_numeric(mods: list[str]) -> list[str]:
    merged: list[str] = []
    for t in mods:
        if t.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{t}"
        else:
            merged.append(t)
    return merged


def _norm_named_mapper(norm_names: tuple[str, ...], rekey=lambda k: k):
    """Key -> flax (collection, path...) for a tree whose norms are the
    modules named in `norm_names`; `rekey` rewrites the key first."""

    def mapper(key: str, value: torch.Tensor) -> tuple:
        *mods, leaf = rekey(key).split(".")
        mods = _merge_numeric(mods)
        if mods[-1] in norm_names:
            coll, name = _NORM_LEAVES[leaf]
            return coll, *mods, name
        return "params", *mods, "kernel" if leaf == "weight" else leaf

    return mapper


def _detr_mapper(key: str, value: torch.Tensor) -> tuple:
    """The DETR demo tree: a 1-D `weight` is a norm's scale (its batch
    norms are bn1, bn2, bn3, downsample.1); the attention's packed
    projections and the embeddings keep their torch names and layout."""
    *mods, leaf = key.split(".")
    mods = _merge_numeric(mods)
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", *mods, _NORM_LEAVES[leaf][1]
    if leaf == "weight":
        return "params", *mods, "scale" if value.ndim == 1 else "kernel"
    return "params", *mods, leaf


def _flatten(tree: Any, prefix: tuple = ()) -> dict[tuple, Any]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def state_from_flax(
    module: nn.Module, variables: Mapping, mapper: Callable[[str, torch.Tensor], tuple]
) -> dict[str, torch.Tensor]:
    """The state dict of `module` filled from a flax `variables` tree
    ({"params", "batch_stats"}, numpy or JAX arrays): each entry's leaf by
    `mapper`, a 4-D kernel HWIO -> OIHW, a 2-D kernel (in, out) -> (out,
    in). Strict: every entry and every flax leaf is used once, shapes
    equal."""
    flat = _flatten(variables)
    used = set()
    out = {}
    for key, ref in module.state_dict().items():
        path = mapper(key, ref)
        if path not in flat:
            raise ValueError(f"{key} -> {'/'.join(path)} is not in the flax tree")
        a = np.asarray(flat[path], np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {a.shape}, module {tuple(ref.shape)}")
        out[key] = torch.tensor(a)
        used.add(path)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"{len(unused)} flax leaves have no module entry, e.g. {unused[:5]}")
    return out


def yolo_state_from_flax(variables: Mapping, graph: nn.Module) -> dict[str, torch.Tensor]:
    """A `YoloGraph`'s state dict from the JAX `YoloGraph`'s variables
    (`model.{i}` is flax `m{i}`)."""
    return state_from_flax(graph, variables,
                           _norm_named_mapper(("bn",), rekey=lambda k: "m" + k[len("model."):]))


def frcnn_state_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """A `D2FasterRCNN`'s state dict from the JAX one's variables."""
    return state_from_flax(model, variables, _norm_named_mapper(("norm",)))


def detr_state_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """A `DETRDemo`'s state dict from the JAX one's variables."""
    return state_from_flax(model, variables, _detr_mapper)


def detector_from_jax(det_jax, device: str | torch.device = "cuda"):
    """The port's counterpart of a JAX detector (toy, YOLO, Faster R-CNN or
    DETR), same configuration, holding its weights."""
    det_jax.load_model()
    kind = type(det_jax).__name__
    if kind == "ToyDetector":
        return toy_detector_from_numpy(
            {k: np.asarray(v) for k, v in det_jax.params.items()},
            det_jax.num_classes, det_jax.channels, device=device,
        )
    if kind == "YoloDetector":
        from .models.yolo import YoloDetector

        det = YoloDetector(det_jax.variant, det_jax.nc, det_jax.imgsz, det_jax.seed, device="cpu")
        fn = yolo_state_from_flax
    elif kind == "FasterRCNNDetector":
        from .models.frcnn import FasterRCNNDetector

        det = FasterRCNNDetector(det_jax.nc, det_jax.seed, det_jax.num_proposals, device="cpu")
        fn = frcnn_state_from_flax
    elif kind == "DetrDetector":
        from .models.detr import DetrDetector

        det = DetrDetector(det_jax.nc, det_jax.seed, det_jax.num_queries, device="cpu")
        fn = detr_state_from_flax
    else:
        raise TypeError(f"no port of {kind}")
    det.model.load_state_dict(fn(det_jax.params, det.model))
    return det.to(resolve_device(device))
