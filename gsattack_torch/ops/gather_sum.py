"""Per-row sum of gathered rows as a CUDA kernel (`csrc/gather_sum.cu`):
`out[g, :] = sum over j of rows[table[g, j], :]` for `table[g, j] >= 0`,
summed in j order.

The blend backward's second step: `ops/blend.py` writes one gradient row
per depth-sorted pair, and this sums each gaussian's rows through the slot
table that `ops/raster.py::bin_gaussians` builds. It is the port's
counterpart of the reference's XLA table backward
(`gsattack/ops/pallas_blend.py::_gather_sum_rows`), which has no Pallas
kernel. The order of the sum is fixed, so the result is reproducible bit
for bit, on the card and on the CPU.

The kernel gives a CTA a block of consecutive gaussians and walks their
table rows in chunks: it compacts the entries a chunk names into shared
memory, stages the named rows there by cp.async with all of a CTA's loads
in flight at once, and adds each gaussian's rows in j order, as
`gather_sum_rows_plain` does (`csrc/gather_sum.cu` has the design and what
bounds it).

`gather_sum_rows` launches the kernel for CUDA tensors and sends CPU
tensors to `gather_sum_rows_plain`, which is also the kernel's oracle. A
build or launch failure raises; nothing on a CUDA tensor takes the plain
route. The counter `gather_sum_launches` (`utils/profiling.py`) is raised
by one exactly where the kernel is launched; a table with no entries (n = 0
or c = 0) is answered with zeros and launches nothing. Either route runs in
the span `blend/gather_sum`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import annotate_fn, count
from . import _cuda

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _cuda.load()
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gs_gather_sum_rows.argtypes = [p, p, i64, i, i, p, p]
        lib.gs_gather_sum_rows.restype = i
        _lib = lib
    return _lib


def gather_sum_rows_plain(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain version: `(rows[table.clamp(min=0)] * (table >= 0)[..., None])
    .sum(1)`, summed column by column in j order as the kernel sums, so
    that the two agree bit for bit."""
    n, c = table.shape
    out = rows.new_zeros((n, rows.shape[1]))
    if rows.shape[0] == 0:
        return out
    safe = table.clamp(min=0).long()
    for j in range(c):
        out = out + torch.where((table[:, j] >= 0)[:, None], rows[safe[:, j]], 0.0)
    return out


def _validate(rows: torch.Tensor, table: torch.Tensor) -> None:
    if rows.device != table.device:
        raise ValueError(f"gather_sum_rows: rows on {rows.device}, table on {table.device}")
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[1] < 1:
        raise ValueError(
            f"gather_sum_rows: rows must be a 2-D float32 tensor of width >= 1, got "
            f"{tuple(rows.shape)} {rows.dtype}"
        )
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError(
            f"gather_sum_rows: table must be a 2-D int32 tensor, got {tuple(table.shape)} "
            f"{table.dtype}"
        )


def _launch(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on validated CUDA tensors: (n, W) float32. A table
    with no entries (n = 0 or c = 0) is answered with zeros, no launch."""
    rows, table = rows.contiguous(), table.contiguous()
    (n, c), w = table.shape, rows.shape[1]
    if n == 0 or c == 0:
        return rows.new_zeros((n, w))
    out = torch.empty((n, w), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = _load().gs_gather_sum_rows(
            rows.data_ptr(), table.data_ptr(), n, c, w, out.data_ptr(),
            _cuda.stream(rows.device),
        )
    if rc != 0:
        raise RuntimeError(f"gather_sum_rows: CUDA error {rc} at launch")
    count("gather_sum_launches")
    return out


@annotate_fn("blend/gather_sum")
def gather_sum_rows(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum of `rows` (P, W) float32 over each row of `table` (n, c) int32,
    entries in [-1, P) (trusted; -1 adds nothing): the kernel on a CUDA
    device, the plain version on the CPU. Raises for any other device."""
    _validate(rows, table)
    if rows.device.type == "cuda":
        return _launch(rows, table)
    if rows.device.type == "cpu":
        return gather_sum_rows_plain(rows, table)
    raise ValueError(f"gather_sum_rows: no route for device {rows.device}")
