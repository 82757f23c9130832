"""Fixtures of the benchmark's own tests: small configurations of the
cells, and the card, decided inside a fixture (never at import).

    python3 -m pytest portbench/tests -q            # CPU; card tests skip
    python3 -m pytest portbench/tests -q -m card    # on a card
"""

import copy
import json
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
CELLS = {"dagger": "dagger-frcnn-4v", "train": "train-3dgs-9v"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def small_cell(kind: str):
    """(workload, config) of a cell at a size the CPU runs in seconds: the
    same kinds, traffic and limits, a 3,000-splat scene at 64 x 64 and, for
    training, a 20-step schedule."""
    wl = json.loads((HERE / "workloads" / f"{CELLS[kind]}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{wl['config']}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["scene"].update(splats=3000, width=64, height=64)
    if kind == "train":
        cfg["train"].update(iterations=20, densify_from_iter=5, densify_until_iter=15,
                            densification_interval=5, opacity_reset_interval=10,
                            sh_increase_interval=6)
    return wl, cfg


def args(kind: str, seed: int = 2 ** 40 + 7, seconds: float = 6.0, trace: int = 0):
    return types.SimpleNamespace(workload=CELLS[kind], seed=seed, seconds=seconds, trace=trace)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
