"""The traced window: `torch.profiler` over the last part of the measured
window (CPU ops and CUDA activity), reduced to what the per-layer readers
take.

The profiler's raw events are read as they come (`kineto_results.events()`)
and not turned into its Python event tree, which would take minutes for
the millions of events of a window. Each device kernel carries the
correlation id of the CPU op that launched it, so a kernel is attributed
to that op by one dictionary lookup.
"""

from __future__ import annotations

import dataclasses
import time

NOT_KERNELS = ("Memcpy", "Memset")
MIN_GAP_S = 10e-6  # gaps shorter than this are launch latency, not attributed


@dataclasses.dataclass
class Trace:
    """A traced window: `kernels` as (name, seconds, the launching op's
    name), `busy_s` the union of every device interval (kernels, copies,
    sets), `window_s` the window's host-clock length."""

    kernels: list
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


class Tracer:
    """`torch.profiler` over the window's last `seconds` (the whole window
    when it is not longer): started, after a synchronise, at the end of the
    first counted step past the window's length less `seconds`, so that
    the attack's own set-up at the window's start stays out; stopped when
    the window closes. Bounding the traced part bounds the trace's size
    and the time to read it, whatever the program's speed. `unit()` is the
    window's per-step callback."""

    def __init__(self, seconds: float, window_s: float):
        self.seconds, self.window = seconds, window_s
        self.units, self.prof, self.window_s = 0, None, None

    def begin(self) -> None:
        """Just before the window opens. The profiler's first start in a
        process loads and sets up CUPTI, which took ~13 s on the H100's
        machine; it is paid here, by a start and stop around nothing,
        so that the start inside the window is quick."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        self.opened = time.perf_counter()
        if self.window <= self.seconds:
            self.start()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        _sync(torch)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def unit(self) -> None:
        if self.prof is not None:
            self.units += 1
        elif time.perf_counter() - self.opened >= self.window - self.seconds:
            self.start()

    def finish(self) -> Trace:
        """At the window's close: stop and read the trace."""
        import torch

        if self.prof is None:
            self.start()
        _sync(torch)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return reduce_events(self.prof.profiler.kineto_results.events(), self.window_s)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def union_seconds(intervals) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def reduce_events(events, window_s: float, top: int = 10) -> Trace:
    """The profiler's events -> Trace. `device_ops` are the kernels of most
    device time, summed by name; `idle_gaps` the device's idle time summed
    by the op whose launch ended each gap, largest first."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, device = {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                               e.linked_correlation_id()))
        elif e.correlation_id() and not e.linked_correlation_id():
            # An op (a runtime call, such as a kernel launch, links to its op).
            ops[e.correlation_id()] = e.name()
    device.sort()
    kernels = [(name, (end - start) * 1e-9, ops.get(link, "?"))
               for start, end, name, link in device if not name.startswith(NOT_KERNELS)]
    by_name, gaps = {}, {}
    for name, sec, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + sec
    reach = None
    for start, end, name, link in device:
        if reach is not None and start - reach > MIN_GAP_S * 1e9:
            what = ops.get(link, name)
            gaps[what] = gaps.get(what, 0.0) + (start - reach) * 1e-9
        reach = end if reach is None else max(reach, end)
    busy = union_seconds((s, e) for s, e, _, _ in device)
    return Trace(
        kernels=kernels, busy_s=busy, window_s=window_s,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    )
