"""The control, the reference computed in the configuration's lower
precision (TF32 for the attack, bfloat16 for training, whose reference
TF32 does not reach) and put in the program's place, reads `correct`
false at the cells' limits. It runs on the card only: on the CPU neither
lower precision exists. On the card at the cells' own sizes,
`python3 -m portbench.calibrate --control-seeds ...` reads it."""

import pytest
import torch

from conftest import small_cell

from portbench import compare


@pytest.mark.card
@pytest.mark.parametrize("kind", ["dagger", "train"])
def test_the_control_is_not_correct(kind, cuda_device):
    from portbench.drivers import dagger, train

    wl, cfg = small_cell(kind)
    cell = (dagger if kind == "dagger" else train).Cell(cfg, wl, 2 ** 36 + 5, cuda_device)
    cell.window(3.0)
    cell.release()
    ref = cell.reference()
    assert compare.verdict(cell.numbers(ref))
    cell.taken = cell.reference(control=True)["record"]
    assert not compare.verdict(cell.numbers(ref)), cell.numbers(ref)
    torch.cuda.empty_cache()
