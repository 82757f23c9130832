"""The share of the traced training window, in %, in which the device is
idle while the host is in `render/project` (or projection's backward
nodes) or `render/bin`: idle gaps put down to the innermost program span
open over them (`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    sp = spans.of(ctx)
    if sp is None or not sp.device or not spans.has(sp, spans.PROJ_BIN):
        return None
    return 100.0 * sum(sp.idle.get(n, 0.0) for n in spans.PROJ_BIN) / sp.window_s
