"""The harness's arithmetic at sizes worked by hand: rates and the step
tail, the idle share of a trace, the blend's work and bounds, FLOPs."""

import math
import types

import pytest
import torch

from portbench import trace, work
from portbench.drivers.train import step_p95_ms
from portbench.metrics import _blend
from portbench.run import metric_reader


def window(stall_every: int):
    """400 steps of 35 ms; every `stall_every`-th stalls 300 ms more."""
    stamps, t = [0.0], 0.0
    for i in range(1, 401):
        t += 0.035 + (0.3 if i % stall_every == 0 else 0.0)
        stamps.append(t)
    return stamps, t


def test_rate_and_tail_over_a_window_with_a_stall():
    from portbench.drivers.train import Cell

    stamps, t = window(10)
    e2e = Cell.end_to_end(types.SimpleNamespace(), {"units": 400, "seconds": t, "stamps": stamps})
    assert e2e["train_it_s"] == pytest.approx(400 / (400 * 0.035 + 40 * 0.3))
    # A tenth of the steps stall: the 95th percentile of every step's time
    # is the stalled step's whole 335 ms, not an average over its block.
    assert e2e["train_step_p95_ms"] == pytest.approx(335.0)
    # One step in a hundred stalls: the tail is the common step.
    assert step_p95_ms(window(100)[0]) == pytest.approx(35.0)
    assert step_p95_ms([0.0, 0.1, 0.3]) == pytest.approx(285.0)  # gaps of 100 and 200 ms


class Ev:
    def __init__(self, name, start_us, dur_us, cuda, cid=0, link=0):
        self.a = (name, int(start_us * 1e3), int(dur_us * 1e3), cuda, cid, link)

    def name(self):
        return self.a[0]

    def start_ns(self):
        return self.a[1]

    def duration_ns(self):
        return self.a[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.a[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self.a[4]

    def linked_correlation_id(self):
        return self.a[5]

    def is_user_annotation(self):
        return False


def synthetic_trace():
    events = [
        Ev("aten::conv2d", 0, 5, False, cid=1), Ev("aten::index", 40, 60, False, cid=2),
        Ev("cudaLaunchKernel", 1, 1, False, cid=7, link=1),
        Ev("conv_fprop", 0, 10, True, link=1), Ev("blend_fwd_kernel<19>", 5, 15, True, link=2),
        Ev("Memcpy DtoH", 100, 10, True, link=2),
        Ev("void gather_sum_rows_kernel<2, false>", 200, 20, True, link=2),
    ]
    return trace.reduce_events(events, window_s=400e-6)


def test_idle_share_and_gaps_of_a_synthetic_trace():
    tr = synthetic_trace()
    # Device intervals [0, 20) [100, 110) [200, 220) us: 50 us busy of 400.
    assert tr.busy_s == pytest.approx(50e-6)
    assert len(tr.kernels) == 3  # the copy is no kernel
    assert tr.idle_gaps[0][0] == "aten::index"
    assert tr.idle_gaps[0][1] == pytest.approx(80e-6 + 90e-6)
    ctx = {"kind": "dagger", "units": 2, "trace": tr, "blend_bound_s": 10e-6, "flops": 67e6}
    assert metric_reader("device_idle_pct.pgd")(ctx) == pytest.approx(100 * (1 - 50 / 400))
    assert metric_reader("device_idle_pct.train")(ctx) is None
    assert metric_reader("launches_per_it.pgd")(ctx) == pytest.approx(1.5)
    assert metric_reader("detector_conv_ms_per_it.pgd")(ctx) == pytest.approx(10e-3 / 2)
    assert _blend.blend_seconds(ctx) == pytest.approx(35e-6)
    assert metric_reader("blend_roofline.pgd")(ctx) == pytest.approx(100 * 20e-6 / 35e-6)
    assert metric_reader("mfu.pgd")(ctx) == pytest.approx(100 * 67e6 * 2 / 400e-6 / 67e12)


def test_a_reader_with_nothing_to_read_returns_nothing():
    tr = trace.reduce_events([], window_s=1.0)
    ctx = {"kind": "dagger", "units": 3, "trace": tr, "blend_bound_s": 1.0, "flops": 1}
    assert metric_reader("blend_roofline.pgd")(ctx) is None
    assert metric_reader("device_idle_pct.pgd")(ctx) is None
    assert metric_reader("blend_ms_per_step.train")({**ctx, "kind": "train"}) is None


def test_pair_work_of_one_splat_on_one_tile_by_hand():
    # One view, one 16 x 16 tile, one splat at (7.5, 7.5), conic (a, 0, a).
    a, op = 0.02, 0.5
    mean2d = torch.tensor([[[7.5, 7.5]]])
    conic = torch.tensor([[[a, 0.0, a]]])
    opacity = torch.tensor([[op]])
    colors = torch.zeros((1, 1, 3))
    idx = (torch.tensor([0]), torch.tensor([[0]]), torch.tensor([[1]]))
    live = 0
    for y in range(16):
        for x in range(16):
            power = -0.5 * a * ((x - 7.5) ** 2 + (y - 7.5) ** 2)
            live += op * math.exp(power) >= 1 / 255
    last = torch.ones((1, 16, 16), dtype=torch.int32)
    w = work.pair_work(idx, [mean2d, conic, opacity, colors], (1, 1), 2048, last)
    assert w == {"fwd_eval": 256, "stops": 0, "bwd_eval": 256, "live": live}
    b = work.blend_bounds(1, 1, 1, 3, 1, 256, 1, w)
    fwd_bytes = 4 + 8 + 9 * 4 + 256 * 5 * 4
    assert b["fwd"] == pytest.approx(max(fwd_bytes / work.PEAK_BYTES_S,
                                         (256 * 17 + live * 10) / work.PEAK_FP32_S))
    assert b["sum_ops"] == 9


def test_flops_of_a_linear_layer():
    lin = torch.nn.Linear(4, 3)
    assert work.flops_of(lambda: lin(torch.ones(2, 4))) == 2 * 2 * 4 * 3


def test_the_tracer_covers_the_window_after_its_first_part():
    tracer = trace.Tracer(seconds=0.0, window_s=1e-9)
    tracer.begin()
    tracer.unit()  # the step that ends the untraced part starts the trace
    assert tracer.prof is not None and tracer.units == 0
    torch.ones(8).sum()
    tracer.unit()
    tracer.unit()
    tr = tracer.finish()
    assert tracer.units == 2 and tr.window_s > 0 and tr.busy_s == 0.0
    whole = trace.Tracer(seconds=20.0, window_s=5.0)
    whole.begin()  # a window no longer than the trace is traced whole
    assert whole.prof is not None
    whole.finish()
