"""The numbers that decide `correct`: the program's steps against the
reference's, by the gap of losses and of per-leaf norms."""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (its gradient is nought to rounding), so it is
# left out of the gradient and change comparisons.
NOUGHT_SHARE = 1e-3


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of the steps' losses; inf when the program
    gave fewer steps or a loss that is not finite."""
    if len(program) < len(reference):
        return math.inf
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def counted_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    norms = {k: _norm(g) for k, g in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NOUGHT_SHARE * med and v > 0]


def norm_gap(program: dict, reference: dict, leaves: list) -> float:
    """The worst leaf's |‖program‖ - ‖reference‖|, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    if not leaves:
        return math.inf
    ref = {k: _norm(reference[k]) for k in leaves}
    med = statistics.median(ref.values())
    worst = 0.0
    for k in leaves:
        p = _norm(program[k])
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def _share(gap: float, ref: float) -> float:
    """`gap` over `ref`; where `ref` is 0, 0 for no gap and inf for any."""
    if not math.isfinite(gap):
        return math.inf
    return gap / ref if ref > 0 else (0.0 if gap == 0 else math.inf)


def diff_gap(program: dict, reference: dict) -> float:
    """The worst key's ‖program - reference‖ over ‖reference‖: tensors of
    one layout, compared element by element."""
    return max(_share(_norm(program[k].cpu().double() - reference[k].cpu().double()),
                      _norm(reference[k])) for k in reference)


def set_gap(program: dict, reference: dict) -> float:
    """The worst key's |‖program‖ - ‖reference‖| over ‖reference‖: rows in
    any order, as the program's slots and the reference's list hold the
    same live splats."""
    return max(_share(abs(_norm(program[k]) - _norm(reference[k])), _norm(reference[k]))
               for k in reference)


def change(params: dict, originals: dict, leaves: list) -> dict:
    """Each leaf's change, in float64 on the host."""
    return {k: params[k].detach().cpu().double() - originals[k].detach().cpu().double()
            for k in leaves}


def moved_leaves(ref_change: dict, leaves: list) -> list:
    """The counted leaves that the reference moves."""
    return [k for k in leaves if _norm(ref_change[k]) > 0]


def verdict(numbers: list) -> bool:
    """`numbers` as (name, value, limit): correct when each is finite and
    at or under its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in numbers)


@contextlib.contextmanager
def precision(lower: str | None):
    """The reference's precision inside the block: float32 with TF32 off,
    or the control's lower precision, the configuration's `control`:
    "tf32" (TF32 on for matrix products and convolutions) or "bf16" (that,
    and bfloat16 autocast of them)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(lower)
    try:
        if lower == "bf16":
            with torch.autocast("cuda", dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
