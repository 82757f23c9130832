"""Runtime calls that wait for the device (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, synchronous `cudaMemcpy`)
per training step of the traced window (`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    sp = spans.of(ctx)
    if sp is None or not sp.device:
        return None
    return len(sp.syncs) / ctx["units"]
