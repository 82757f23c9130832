"""Kernel launches on the device per training step of the traced window."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] or not ctx["trace"].kernels:
        return None
    return len(ctx["trace"].kernels) / ctx["units"]
