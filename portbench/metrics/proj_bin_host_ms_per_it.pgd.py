"""Host ms per PGD iteration in the program's `render/project` and
`render/bin` spans, with projection's backward nodes, inside the
iterations' `pgd/iter` spans (the loss and eval renders;
`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    if ctx["kind"] != "dagger" or not ctx["units"]:
        return None
    sp = spans.of(ctx)
    if sp is None:
        return None
    sec = spans.host_seconds(sp, spans.PROJ_BIN, spans.UNIT_SPAN["dagger"])
    return 1e3 * sec / ctx["units"] if sec > 0 else None
