"""The program's stage spans in the traced window (`portbench/spans.py`):
idle gaps and synchronisations put down to spans on synthetic events
worked by hand, projection's backward found by sequence numbers, the new
readers, a traced run on the CPU, and on a card the shared clock of spans
and kernels."""

import pytest
import torch

from portbench import spans
from portbench.run import metric_reader

US = 1000  # ns


class Ev:
    """A raw profiler event as `reduce` reads it (times in us)."""

    def __init__(self, name, start_us, dur_us, cuda=False, span=False, tid=1, seq=-1,
                 fwd_tid=0):
        self.a = (name, int(start_us * US), int(dur_us * US), cuda, span, tid, seq, fwd_tid)

    def name(self):
        return self.a[0]

    def start_ns(self):
        return self.a[1]

    def duration_ns(self):
        return self.a[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.a[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.a[4]

    def start_thread_id(self):
        return self.a[5]

    def sequence_nr(self):
        return self.a[6]

    def fwd_thread_id(self):
        return self.a[7]


def kernel(start, dur):
    return Ev("k", start, dur, cuda=True)


def window():
    """A step 0-1000 us on thread 1: project 0-300 (a forward op of seq 7
    at 10), bin 300-500 with a synchronise at 350, then the step's
    backward 600-950, in which the engine's thread 2 runs the node of seq 7
    at 700-800. The device runs 0-20, 200-220, 560-580 and 900-1000."""
    return [
        Ev("train/step", 0, 1000, span=True), Ev("render/project", 0, 300, span=True),
        Ev("aten::mul", 10, 5, seq=7), Ev("aten::sum", 400, 5, seq=8),
        Ev("render/bin", 300, 200, span=True), Ev("cudaStreamSynchronize", 350, 40),
        Ev("cudaLaunchKernel", 360, 2), Ev("train/backward", 600, 350, span=True),
        Ev("autograd::engine::evaluate_function: MulBackward0", 700, 100, tid=2, seq=7,
           fwd_tid=1),
        Ev("autograd::engine::evaluate_function: SumBackward0", 650, 20, tid=2, seq=8,
           fwd_tid=1),
        Ev("cudaDeviceSynchronize", 1010, 5),
        kernel(0, 20), kernel(200, 20), kernel(560, 20), kernel(900, 100),
    ]


def test_idle_gaps_go_to_the_innermost_span_split_by_overlap():
    sp = spans.reduce(window(), window_s=1e-3)
    assert sp.gaps == [(20 * US, 200 * US), (220 * US, 560 * US), (580 * US, 900 * US)]
    got = {k: round(v * 1e9) for k, v in sp.idle.items()}
    # 20-200 project; 220-300 project, 300-500 bin, 500-560 step; 580-600
    # step, 600-700 backward, 700-800 the node (it opened last), 800-900
    # backward.
    assert got == {"render/project": 260 * US, "render/bin": 200 * US,
                   "train/step": 80 * US, "train/backward": 200 * US,
                   spans.BACKWARD: 100 * US}
    assert sp.device and sp.window_s == 1e-3


def test_synchronisations_go_to_the_span_open_at_their_start():
    sp = spans.reduce(window(), window_s=1e-3)
    assert sp.syncs == [(350 * US, "cudaStreamSynchronize"), (1010 * US, "cudaDeviceSynchronize")]
    assert sp.synced == {"render/bin": 1, spans.NO_SPAN: 1}


def test_projection_backward_is_found_by_sequence_number():
    sp = spans.reduce(window(), window_s=1e-3)
    back = [(s, e) for s, e, name, _ in sp.spans if name == spans.BACKWARD]
    # seq 8 was made in render/bin, not in render/project: not projection's.
    assert back == [(700 * US, 800 * US)]
    sec = spans.host_seconds(sp, spans.PROJ_BIN, "train/step")
    assert sec == pytest.approx((300 + 100 + 200) * 1e-6)
    assert spans.host_seconds(sp, spans.PROJ_BIN, "pgd/iter") == 0.0


def test_what_no_span_covers_is_no_span():
    sp = spans.reduce([kernel(0, 10), Ev("render/blend", 15, 20, span=True),
                       kernel(50, 10), kernel(100, 5)], window_s=1e-4)
    assert sp.idle == {"render/blend": pytest.approx(20e-6), spans.NO_SPAN: pytest.approx(60e-6)}
    assert spans.owner_at(spans.timeline(sp.spans), 15 * US) == "render/blend"
    assert spans.owner_at(spans.timeline(sp.spans), 35 * US) == spans.NO_SPAN


def test_the_readers_on_a_window_worked_by_hand():
    sp = spans.reduce(window(), window_s=1e-3)
    ctx = {"kind": "train", "units": 2, "spans": sp}
    assert metric_reader("proj_bin_host_ms_per_step.train")(ctx) == pytest.approx(0.3)
    assert metric_reader("proj_bin_idle_pct.train")(ctx) == pytest.approx(100 * 560e-6 / 1e-3)
    assert metric_reader("syncs_per_step.train")(ctx) == pytest.approx(1.0)
    assert metric_reader("proj_bin_host_ms_per_it.pgd")(ctx) is None
    assert metric_reader("syncs_per_it.pgd")({**ctx, "kind": "dagger"}) == pytest.approx(1.0)


def test_a_program_without_spans_reads_nothing_but_its_synchronisations():
    events = [e for e in window() if not e.is_user_annotation()]
    ctx = {"kind": "train", "units": 2, "spans": spans.reduce(events, window_s=1e-3)}
    assert metric_reader("proj_bin_host_ms_per_step.train")(ctx) is None
    assert metric_reader("proj_bin_idle_pct.train")(ctx) is None
    assert metric_reader("syncs_per_step.train")(ctx) == pytest.approx(1.0)
    assert ctx["spans"].idle == {spans.NO_SPAN: pytest.approx(840e-6)}
    assert metric_reader("proj_bin_host_ms_per_it.pgd")({**ctx, "kind": "dagger"}) is None


def test_a_traced_training_run_reports_its_stages(capsys):
    """`run_cell` on the CPU: the host-time and pair readers find the
    running trace; with no device activity the idle and synchronisation
    readers read nothing."""
    import json

    from conftest import args, small_cell

    from portbench import run

    wl, cfg = small_cell("train")
    assert run.run_cell(args("train", seconds=2.0, trace=1), wl, cfg, torch.device("cpu")) == 0
    out = capsys.readouterr()
    metrics = json.loads(out.out.splitlines()[-1])["metrics"]
    assert metrics["proj_bin_host_ms_per_step.train"]["value"] > 0
    assert metrics["pairs_per_step.train"]["value"] > 0
    assert "syncs_per_step.train" not in metrics and "proj_bin_idle_pct.train" not in metrics
    err = out.err.splitlines()
    table = next(i for i, ln in enumerate(err) if "device idle by program span" in ln)
    assert table < next(i for i, ln in enumerate(err) if ln.startswith("check "))


@pytest.mark.card
def test_spans_and_kernels_share_the_clock(cuda_device):
    """Every blend forward kernel starts after the start of its
    `render/blend` span, in order, one a span; the blend's backward spans
    and projection's backward nodes are found on the engine's thread."""
    from conftest import small_cell
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import train

    wl, cfg = small_cell("train")
    cell = train.Cell(cfg, wl, 2 ** 36 + 11, cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cell.window(2.0)
    events = prof.profiler.kineto_results.events()
    blends = sorted(e.start_ns() for e in events
                    if e.is_user_annotation() and e.name() == "render/blend"
                    and e.device_type() != torch.autograd.DeviceType.CUDA)
    kernels = sorted(e.start_ns() for e in events
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and "blend_fwd_kernel" in e.name())
    assert len(kernels) == len(blends) > 0
    assert all(k >= s for k, s in zip(kernels, blends))
    assert all(k < s for k, s in zip(kernels, blends[1:]))
    sp = spans.reduce(events, window_s=2.0)
    threads = {tid for _, _, name, tid in sp.spans if name == "train/step"}
    backward = {tid for _, _, name, tid in sp.spans if name == "blend/backward"}
    assert backward and not backward & threads
    assert any(name == spans.BACKWARD for _, _, name, _ in sp.spans)
    assert sp.syncs
    cell.release()
    torch.cuda.empty_cache()
