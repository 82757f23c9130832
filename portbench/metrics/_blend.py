"""Shared by the metric readers: which kernels are the blend's and which
the detector's convolutions."""

BLEND_KERNELS = ("blend_fwd_kernel", "blend_bwd_kernel", "gather_sum_rows_kernel")


def is_blend(kernel_name: str) -> bool:
    """A kernel that the blend's entry points launch (ops/blend.py and
    ops/gather_sum.py)."""
    return any(k in kernel_name for k in BLEND_KERNELS)


def is_convolution(op_name: str) -> bool:
    """A kernel launched under one of the profiler's convolution ops,
    forward or backward."""
    return "convolution" in op_name or "conv2d" in op_name


def blend_seconds(ctx) -> float:
    return sum(sec for name, sec, _ in ctx["trace"].kernels if is_blend(name))
