"""Device ms per training step of the kernels the blend's entry points
launch (forward, backward and the per-splat sum)."""
from portbench.metrics import _blend


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    sec = _blend.blend_seconds(ctx)
    return 1e3 * sec / ctx["units"] if sec > 0 else None
