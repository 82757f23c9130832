"""Kernel launches on the device per PGD iteration of the traced window."""


def read(ctx):
    if ctx["kind"] != "dagger" or not ctx["units"] or not ctx["trace"].kernels:
        return None
    return len(ctx["trace"].kernels) / ctx["units"]
