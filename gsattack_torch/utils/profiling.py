"""Spans, counters, device traces and a host-side stage timer. Port of
`gsattack/utils/profiling.py` over `torch.profiler`.

`annotate` / `annotate_fn` name a span of the program: while a profiler
records, a `record_function`, so that the span lies in the same trace as
the kernels, on their clock; while none records, a shared no-op after one
flag check that does not enter the dispatcher (a disabled
`record_function` still calls a registered op on entry and exit). Spans
are named `layer/stage`: `render/project`, `render/bin`, `render/blend`,
`blend/backward`, `blend/gather_sum`, `train/*`, `pgd/*`, `detector/*`,
`dagger/*`.

`count` adds to a named host integer; `counters()` copies them. A counter
never reads a device tensor, so counting adds no launch and no
synchronise. The counts made while a profiler records are also kept on
their own (`counters(traced=True)`), so that a trace's reader can put them
over the trace's steps. The counters: `blend_fwd_launches`,
`blend_bwd_launches`, `gather_sum_launches` and `gather_launches` (one per
kernel launch), and `pairs_binned` (the sorted pairs of each `bin_views`).

`trace_to` records the host and, where a card is present, its kernels into
a Chrome trace, and `StageTimer` sums host wall time by stage for a
command's summary, waiting for the card where it is given a tensor to wait
on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: dict = {}
_TRACED: dict = {}


def annotate(name: str):
    """A named span (a context manager): a `record_function` while a
    profiler records, else a shared no-op."""
    if not _recording():
        return _OFF
    return record_function(name)


def annotate_fn(name: str):
    """Decorator: run the function inside a span named `name`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with annotate(name):
                return fn(*a, **k)

        return wrapped

    return deco


def count(name: str, n: int = 1) -> None:
    """Add the host integer `n` to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _recording():
        _TRACED[name] = _TRACED.get(name, 0) + n


def counters(traced: bool = False) -> dict:
    """A copy of the counters: every count since import, or with `traced`
    only those made while a profiler recorded."""
    return dict(_TRACED if traced else _COUNTS)


@contextlib.contextmanager
def trace_to(dir_path: str) -> Iterator[profile]:
    """Trace the host and, where a card is present, the card while the
    block runs; on exit the Chrome trace is written to
    `dir_path/trace.json` (chrome://tracing or Perfetto opens it). Yields
    the profiler, whose `key_averages()` sums the trace by name."""
    os.makedirs(dir_path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dir_path, TRACE_FILE))


def _wait_for(x) -> None:
    """Wait for the cards that hold the tensors in `x` (a tensor, or a
    list, tuple or dict of them) to finish their queued work."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _wait_for(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _wait_for(v)


class StageTimer:
    """Host-side accumulating stage timer. A stage given `block_on` waits
    for the card holding those tensors before it stops the clock, so that
    its time covers the work it queued."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:28s} {t:8.3f}s total  {t / max(c, 1) * 1e3:8.2f}ms/call  x{c}")
        return "\n".join(lines)
