"""The whole PGD iteration's share of the H100's fp32 peak (67 TFLOP/s;
the program runs with TF32 off), in %: the FLOPs an iteration needs (the
detector's loss forward, image-gradient backward and eval forwards,
counted on the reference detector, and the blend's operations) times the
iterations, over the traced window's time."""

from portbench.work import PEAK_FP32_S


def read(ctx):
    if ctx["kind"] != "dagger" or not ctx["units"] or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] * ctx["units"] / ctx["trace"].window_s / PEAK_FP32_S
