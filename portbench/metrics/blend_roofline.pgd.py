"""The blend kernels' share of their roofline per PGD iteration, in %: the
least time of one loss render's forward and backward (with its per-splat
sum) and one eval render's forward, at the reference's binning of the
cell's scene and views, over the device time of the kernels the blend's
entry points launch."""
from portbench.metrics import _blend


def read(ctx):
    if ctx["kind"] != "dagger" or not ctx["units"] or "blend_bound_s" not in ctx:
        return None
    sec = _blend.blend_seconds(ctx)
    return 100.0 * ctx["blend_bound_s"] * ctx["units"] / sec if sec > 0 else None
