"""`gsattack_torch.ops.gather` against `gsattack.ops.pallas_gather`: the
port's `gather_rows` on CPU tensors (its plain version) against the Pallas
kernel in interpret mode on the same numpy-seeded inputs, the plain
version's edge cases against numpy, the wrapper's validation, and CPU dry
runs of the micro-bench `python -m gsattack_torch.scripts.micro_gather`.
A gather is a copy, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.ops.pallas_gather import gather_rows as j_gather_rows
from gsattack_torch.ops import gather
from gsattack_torch.scripts import micro_gather
from gsattack_torch.utils.profiling import counters

torch.set_num_threads(2)


def _inputs(s, m, w, seed):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(s, w)).astype(np.float32)
    idx = rng.integers(0, s, size=m).astype(np.int32)
    return src, idx


@pytest.mark.parametrize("m", [256, 512])
@pytest.mark.parametrize("w", [8, 16, 40])
def test_gather_rows_matches_pallas_interpret(w, m):
    src, idx = _inputs(300, m, w, seed=w)
    ref = j_gather_rows(jnp.asarray(src), jnp.asarray(idx), block=64, n_sem=4, unroll=4,
                        interpret=True)
    got = gather.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), src[idx])


@pytest.mark.parametrize("s,m,w,repeat", [
    (300, 0, 16, False),   # M = 0: an empty (0, W) result
    (1, 64, 16, False),    # S = 1: every index 0
    (50, 200, 16, True),   # repeated indices
    (97, 300, 3, False),   # W = 3, not a multiple of 4
    (500, 1001, 40, False),  # M not a multiple of anything
])
def test_gather_rows_plain_edge_cases(s, m, w, repeat):
    src, idx = _inputs(s, m, w, seed=1)
    if repeat:
        idx = np.tile(np.array([7, 0, 49, 7], np.int32), m // 4)
    t_src, t_idx = torch.from_numpy(src), torch.from_numpy(idx)
    for got in (gather.gather_rows_plain(t_src, t_idx), gather.gather_rows(t_src, t_idx)):
        assert got.shape == (idx.shape[0], w) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), src[idx])


def test_gather_rows_cpu_takes_plain_route():
    before = counters().get("gather_launches", 0)
    src, idx = _inputs(30, 40, 8, seed=2)
    gather.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    assert counters().get("gather_launches", 0) == before


@pytest.mark.parametrize("src,idx,match", [
    (torch.zeros(10, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), "float32"),
    (torch.zeros(10, 4), torch.zeros(3, dtype=torch.int64), "int32"),
    (torch.zeros(40), torch.zeros(3, dtype=torch.int32), "2-D"),
    (torch.zeros(4, 10).t(), torch.zeros(3, dtype=torch.int32), "contiguous"),
    (torch.zeros(10, 4), torch.zeros(3, 1, dtype=torch.int32), "1-D"),
    (torch.zeros(10, 4), torch.zeros(3, dtype=torch.int32, device="meta"), "meta"),
    (torch.zeros(1, 16), torch.zeros(1, dtype=torch.int32).expand(2**27), "2\\^31"),
    (torch.zeros(10, 4, device="meta"), torch.zeros(3, dtype=torch.int32, device="meta"),
     "no route"),
])
def test_gather_rows_validates(src, idx, match):
    with pytest.raises(ValueError, match=match):
        gather.gather_rows(src, idx)


@pytest.mark.parametrize("mode", micro_gather.MODES)
def test_micro_gather_cpu_dry_run(mode, capsys):
    rc = micro_gather.main([mode, "--device", "cpu", "--s", "300", "--m", "256",
                            "--sizes", "50,300", "--widths", "8,16,40", "--threads", "256",
                            "--in-flight", "1,4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "not timed (cpu dry run)" in out and "MISMATCH" not in out


def test_micro_gather_exits_nonzero_on_mismatch(monkeypatch, capsys):
    def wrong(src, idx, **kw):
        out = gather.gather_rows_plain(src, idx)
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(gather, "gather_rows", wrong)
    rc = micro_gather.main(["main", "--device", "cpu", "--s", "300", "--m", "256",
                            "--threads", "256", "--in-flight", "4"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "kernel_t256_f4 MISMATCH" in out and "FAILED" in out


def test_micro_gather_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        micro_gather.main(["main", "--s", "300", "--m", "256"])
