"""Trace annotations, device traces and a host-side stage timer. Port of
`gsattack/utils/profiling.py` over `torch.profiler`.

`annotate` / `annotate_fn` name a span in a trace, `trace_to` records one
(the host and, where a card is present, its kernels) into a Chrome trace,
and `StageTimer` sums host wall time by stage for a command's summary,
waiting for the card where it is given a tensor to wait on.
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


def annotate(name: str):
    """A named span in a `torch.profiler` trace (a context manager)."""
    return record_function(name)


def annotate_fn(name: str):
    """Decorator: run the function inside a span named `name`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)

        return wrapped

    return deco


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
