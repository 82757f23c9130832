"""Device ms per PGD iteration of the kernels launched under the
profiler's convolution ops (the detector's, forward and backward: the
render path has no convolution)."""
from portbench.metrics import _blend


def read(ctx):
    if ctx["kind"] != "dagger" or not ctx["units"]:
        return None
    sec = sum(s for _, s, op in ctx["trace"].kernels if _blend.is_convolution(op))
    return 1e3 * sec / ctx["units"] if sec > 0 else None
