"""Host ms per training step in the program's `render/project` and
`render/bin` spans, with projection's backward nodes, inside the steps'
`train/step` spans (`portbench/spans.py`): the host work of projection and
binning."""
from portbench import spans


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    sp = spans.of(ctx)
    if sp is None:
        return None
    sec = spans.host_seconds(sp, spans.PROJ_BIN, spans.UNIT_SPAN["train"])
    return 1e3 * sec / ctx["units"] if sec > 0 else None
