"""`gsattack_torch.ops.gather_sum` against `gsattack.ops.pallas_blend`: the
port's `gather_sum_rows` on CPU tensors (its plain version, the kernel's
oracle) against the reference's table backward `_gather_sum_rows` (a
masked gather and a (c, 1) window sum in XLA) on the same numpy-seeded
inputs: rows of W floats, and a slot table with about 85% of its entries
-1 and some pairs named more than once. Both add each gaussian's rows in
j order; the tolerance (max abs 1e-6) allows XLA another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.ops.pallas_blend import _gather_sum_rows as j_gather_sum_rows
from gsattack_torch.ops.gather_sum import gather_sum_rows

torch.set_num_threads(2)

P, N = 300, 97  # pairs (rows), gaussians (table rows)


def _inputs(w, c, seed):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(P, w)).astype(np.float32)
    table = rng.integers(0, P, size=(N, c))
    table[rng.uniform(size=(N, c)) < 0.85] = -1
    table[0] = 5  # one pair along a whole row
    table[1, ::2] = 11  # and in every other slot
    return rows, table.astype(np.int32)


@pytest.mark.parametrize("c", [1, 12, 40])
@pytest.mark.parametrize("w", [9, 25, 40])
def test_gather_sum_rows_matches_reference(w, c):
    rows, table = _inputs(w, c, seed=100 * w + c)
    got = gather_sum_rows(torch.from_numpy(rows), torch.from_numpy(table)).numpy()
    want = np.asarray(j_gather_sum_rows(jnp.asarray(rows), jnp.asarray(table.reshape(-1)), c))
    assert got.shape == want.shape == (N, w)
    assert (table >= 0).mean() < 0.3 and (table[2:] >= 0).any()
    assert np.abs(got - want).max() <= 1e-6
