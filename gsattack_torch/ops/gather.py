"""Row gather, `out[k] = src[idx[k]]`, as a CUDA kernel (`csrc/gather.cu`).

It replaces the TPU kernel of `gsattack/ops/pallas_gather.py`
(`_gather_rows_kernel`, behind `gather_rows`). That kernel's knobs
(`block`, `n_sem`, `unroll`, `interpret`) steer Mosaic's DMAs and have no
meaning on the card; here the launch takes `threads` per CTA and `in_flight`
loads per thread. M need not be a multiple of anything, but M * W must stay
under 2^31 (an 8 GiB output), on the CPU too. Indices are trusted
to lie in [0, S), as in the JAX function. There is no backward: the Pallas
call has none.

`gather_rows` launches the kernel for CUDA tensors and sends CPU tensors to
`gather_rows_plain`, which is also the kernel's oracle. A build or launch
failure raises; nothing on a CUDA tensor takes the plain route.
The counter `gather_launches` (`utils/profiling.py`) is raised by one
exactly where the kernel is launched.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import _cuda

THREADS = 256  # threads per CTA, a multiple of 32 in [32, 1024]
IN_FLIGHT = 4  # loads each thread keeps in flight: 1, 2, 4 or 8
MAX_OUT = 2**31  # M * W must stay under it, on every device

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _cuda.load()
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gs_gather_rows.argtypes = [p, p, p, i64, i, i64, i, i, p]
        lib.gs_gather_rows.restype = i
        _lib = lib
    return _lib


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k] = src[idx[k]] in plain PyTorch: the CPU route and the oracle."""
    return src[idx.long()]


def _validate(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.device != idx.device:
        raise ValueError(f"gather_rows: src on {src.device}, idx on {idx.device}")
    if src.dim() != 2 or src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError(
            f"gather_rows: src must be a 2-D contiguous float32 tensor, got "
            f"{tuple(src.shape)} {src.dtype}"
            f"{'' if src.is_contiguous() else ' (not contiguous)'}"
        )
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(
            f"gather_rows: idx must be a 1-D int32 tensor, got {tuple(idx.shape)} {idx.dtype}"
        )
    if idx.shape[0] * src.shape[1] >= MAX_OUT:
        raise ValueError(
            f"gather_rows: an output of {idx.shape[0]} x {src.shape[1]} floats is not under "
            "2^31, the kernel's 32-bit piece index"
        )


def _launch(src: torch.Tensor, idx: torch.Tensor, threads: int, in_flight: int) -> torch.Tensor:
    """Launch the kernel on validated CUDA tensors: (M, W) float32. An
    empty output (M or W of 0) is returned without a launch."""
    idx = idx.contiguous()
    (s, w), m = src.shape, idx.shape[0]
    out = torch.empty((m, w), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        rc = _load().gs_gather_rows(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), s, w, m, threads, in_flight,
            _cuda.stream(src.device),
        )
    if rc == -1:
        raise ValueError(
            f"gather_rows: no launch for threads={threads}, in_flight={in_flight} "
            "(threads a multiple of 32 in [32, 1024]; in_flight 1, 2, 4 or 8)"
        )
    if rc == -2:
        raise ValueError(f"gather_rows: {m} rows requested from an empty table")
    if rc != 0:
        raise RuntimeError(f"gather_rows: CUDA error {rc} at launch")
    count("gather_launches")
    return out


def gather_rows(src: torch.Tensor, idx: torch.Tensor, *, threads: int = THREADS,
                in_flight: int = IN_FLIGHT) -> torch.Tensor:
    """out[k] = src[idx[k]] for a 2-D contiguous float32 `src` (S, W) and a
    1-D int32 `idx` (M,) on one device: the kernel on a CUDA device, the
    plain version on the CPU. Raises for any other device."""
    _validate(src, idx)
    if src.device.type == "cuda":
        return _launch(src, idx, threads, in_flight)
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    raise ValueError(f"gather_rows: no route for device {src.device}")
