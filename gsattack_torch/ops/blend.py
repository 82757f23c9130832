"""The tile blend's CUDA kernels (`csrc/blend.cu`) behind a
`torch.autograd.Function`.

`blend` launches the forward kernel, and autograd launches the backward
kernel, then `ops/gather_sum.py`'s kernel; the two blend kernels replace
the TPU kernels of `gsattack/ops/pallas_blend.py` (`_fwd_kernel` and
`_bwd_kernel`). The backward writes one gradient row per depth-sorted
pair, and `gather_sum_rows` sums each gaussian's rows in a fixed order
over the binning's slot table (`ops/raster.py::bin_gaussians`), so that
the gradients are the same from run to run, bit for bit. Their plain
version is `ops/raster.py::blend_tiles_plain`, whose autograd is the
backward through the same slot table; the raster module sends CPU tensors
there and CUDA tensors here.

The library is built from the checkout's `csrc/*.cu` on first use and
loaded by `ops/_cuda.py`, so importing this module needs neither CUDA nor a
compiler.

The counters `blend_fwd_launches` and `blend_bwd_launches`
(`utils/profiling.py`) count the kernel launches; each is raised by one
exactly where its kernel is launched. The backward runs in the span
`blend/backward`, its per-gaussian sum in `blend/gather_sum` inside it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import annotate, count
from . import _cuda
from .gather_sum import gather_sum_rows

CHANNELS = (3, 19)  # channel counts the kernels are instantiated for

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _cuda.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gs_blend_fwd.argtypes = [p] * 7 + [i] * 5 + [p] * 4
        lib.gs_blend_fwd.restype = i
        lib.gs_blend_bwd.argtypes = [p] * 7 + [i] * 4 + [p] * 6
        lib.gs_blend_bwd.restype = i
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc == -1:
        raise ValueError(f"{what}: no kernel for this channel count; have {CHANNELS}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _validate(gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors):
    dev = colors.device
    if dev.type != "cuda":
        raise ValueError(f"blend kernel needs CUDA tensors, got {dev}")
    v, n, n_ch = colors.shape
    if n_ch not in CHANNELS:
        raise ValueError(f"blend kernel: {n_ch} channels, have kernels for {CHANNELS}")
    want = {
        "mean2d": (mean2d, (v, n, 2), torch.float32),
        "conic": (conic, (v, n, 3), torch.float32),
        "opacity": (opacity, (v, n), torch.float32),
        "colors": (colors, (v, n, n_ch), torch.float32),
        "gauss_idx": (gauss_idx, (gauss_idx.shape[0],), torch.int32),
        "tile_start": (tile_start, (v, tile_start.shape[1]), torch.int32),
        "tile_end": (tile_end, tuple(tile_start.shape), torch.int32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"blend kernel: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"want {shape} {dtype} on {dev}"
            )


def forward_kernel(gauss_idx, tile_start, tile_end, mean2d, conic, opacity,
                   colors, tiles_x: int, tiles_y: int, cap: int):
    """Launch the forward kernel on contiguous, validated inputs: image
    (V, H_pad, W_pad, CH), final T (V, H_pad, W_pad), and per pixel the
    count of pairs up to its last contributor (int32)."""
    v, _, n_ch = colors.shape
    dev = colors.device
    shape = (v, tiles_y * 16, tiles_x * 16)
    img = torch.empty(shape + (n_ch,), dtype=torch.float32, device=dev)
    T = torch.empty(shape, dtype=torch.float32, device=dev)
    last = torch.empty(shape, dtype=torch.int32, device=dev)
    rc = _load().gs_blend_fwd(
        mean2d.data_ptr(), conic.data_ptr(), opacity.data_ptr(), colors.data_ptr(),
        gauss_idx.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
        n_ch, v, tiles_x, tiles_y, cap,
        img.data_ptr(), T.data_ptr(), last.data_ptr(), _cuda.stream(dev),
    )
    _check(rc, "blend forward")
    count("blend_fwd_launches")
    return img, T, last


def backward_kernel(gauss_idx, tile_start, tile_end, mean2d, conic, opacity,
                    colors, tiles_x: int, tiles_y: int, T, last, g_img, g_T):
    """Launch the backward kernel from the forward's (T, last) state and
    the output gradients: one gradient row per sorted pair, (P, 6 + CH):
    mean2d 2, conic 3, opacity 1, then the colours (zero for a pair that no
    pixel composites; rows of pairs outside every tile's range are not
    written)."""
    v, _, n_ch = colors.shape
    if g_img.data_ptr() % 16:  # the kernel reads g_img's tile rows in 16-byte pieces
        g_img = g_img.clone()
    d_pair = torch.empty((gauss_idx.shape[0], 6 + n_ch), dtype=torch.float32,
                         device=colors.device)
    rc = _load().gs_blend_bwd(
        mean2d.data_ptr(), conic.data_ptr(), opacity.data_ptr(), colors.data_ptr(),
        gauss_idx.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
        n_ch, v, tiles_x, tiles_y,
        T.data_ptr(), last.data_ptr(), g_img.data_ptr(), g_T.data_ptr(),
        d_pair.data_ptr(), _cuda.stream(colors.device),
    )
    _check(rc, "blend backward")
    count("blend_bwd_launches")
    return d_pair


def split_rows(rows: torch.Tensor, v: int, n: int):
    """Per-gaussian rows (V * N, 6 + CH) as the gradients of mean2d
    (V, N, 2), conic (V, N, 3), opacity (V, N) and colors (V, N, CH)."""
    rows = rows.reshape(v, n, -1)
    return rows[..., 0:2], rows[..., 2:5], rows[..., 5], rows[..., 6:]


class _BlendFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors, gauss_idx, tile_start,
                tile_end, slot_table, tiles_x, tiles_y, cap):
        inputs = [x.contiguous() for x in (gauss_idx, tile_start, tile_end, mean2d,
                                            conic, opacity, colors)]
        img, T, last = forward_kernel(*inputs, tiles_x, tiles_y, cap)
        ctx.save_for_backward(*inputs, slot_table, T, last)
        ctx.tiles = (tiles_x, tiles_y)
        ctx.mark_non_differentiable(last)
        return img, T, last

    @staticmethod
    def backward(ctx, g_img, g_T, _g_last):
        with annotate("blend/backward"):
            *inputs, slot_table, T, last = ctx.saved_tensors
            v, n, n_ch = inputs[-1].shape
            g_img = (T.new_zeros(T.shape + (n_ch,)) if g_img is None else g_img.contiguous())
            g_T = T.new_zeros(T.shape) if g_T is None else g_T.contiguous()
            d_pair = backward_kernel(*inputs, *ctx.tiles, T, last, g_img, g_T)
            grads = split_rows(gather_sum_rows(d_pair, slot_table), v, n)
        return (*grads, None, None, None, None, None, None, None)


def blend(gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors,
          tiles_x: int, tiles_y: int, cap: int, slot_table=None):
    """Image (V, H_pad, W_pad, CH) and final transmittance (V, H_pad, W_pad)
    from the blend kernels, differentiable through the backward kernels.
    Arguments as `ops/raster.py::blend_tiles_plain`, with the per-tile cap
    in pairs; `slot_table` (V * N, c) int32 names each gaussian's sorted
    pairs (-1: none), as `bin_gaussians` gives it, and is built from the
    pair list when not given. Raises for tensors that are not on a CUDA
    device."""
    from .raster import slot_table_of

    _validate(gauss_idx, tile_start, tile_end, mean2d, conic, opacity, colors)
    v, n, _ = colors.shape
    if slot_table is None:
        slot_table = slot_table_of(gauss_idx, tile_start, tile_end, v * n)
    if (slot_table.dim() != 2 or slot_table.shape[0] != v * n
            or slot_table.dtype != torch.int32 or slot_table.device != colors.device):
        raise ValueError(
            f"blend kernel: slot_table is {tuple(slot_table.shape)} {slot_table.dtype} on "
            f"{slot_table.device}, want ({v * n}, c) torch.int32 on {colors.device}"
        )
    img, T, _ = _BlendFunction.apply(mean2d, conic, opacity, colors, gauss_idx,
                                     tile_start, tile_end, slot_table.contiguous(),
                                     tiles_x, tiles_y, cap)
    return img, T
