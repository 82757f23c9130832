from .densify import (
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    grow_capacity,
    reset_opacity,
)
from .trainer import TrainConfig, Trainer, TrainState, make_lr_tree

__all__ = [
    "DensifyStats",
    "add_densification_stats",
    "densify_and_prune",
    "grow_capacity",
    "reset_opacity",
    "TrainConfig",
    "Trainer",
    "TrainState",
    "make_lr_tree",
]
