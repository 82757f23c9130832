"""Sorted pairs binned per training step of the traced window: the
program's counter `pairs_binned` (each `bin_views` adds its pairs), as
counted while the profiler recorded, over the traced steps. The blend's
work count."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    from gsattack_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:  # a program without the counters
        return None
    n = counters(traced=True).get("pairs_binned", 0)
    return n / ctx["units"] if n else None
