"""A whole run of each cell on the CPU at a small size, with the timed
path broken underneath, reads `correct` false; the same run unbroken reads
true. The faults: a step that returns its state unchanged, half of the
batch left out (the mean over the rest), an answer altered where it is
produced, and for training densify's children and the opacity reset's
opacities altered where they are written. The cells run on one chip: there is no exchange between chips to
leave out."""

import json

import pytest
import torch

from conftest import args, small_cell

from portbench import run
from portbench.faults import FAULTS, plant


def run_small(kind: str, capsys, seconds: float) -> dict:
    wl, cfg = small_cell(kind)
    assert run.run_cell(args(kind, seconds=seconds), wl, cfg, torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


SECONDS = {"dagger": 9.0, "train": 4.0}


@pytest.mark.parametrize("kind", ["dagger", "train"])
def test_a_sound_run_is_correct(kind, capsys):
    out = run_small(kind, capsys, SECONDS[kind])
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("kind,fault", [(k, f) for k in ("dagger", "train") for f in FAULTS[k]])
def test_a_broken_run_is_not_correct(kind, fault, capsys, monkeypatch):
    plant(kind, fault, monkeypatch.setattr)
    out = run_small(kind, capsys, SECONDS[kind])
    assert not out["correct"], out["checks"]
