"""The program's stage spans over the traced window, on the device trace's
clock: the device's idle time and the runtime's synchronisations put down
to the stage the host was in, and the host time of a stage.

The program names its stages with `gsattack_torch.utils.profiling.annotate`,
a `record_function` while the profiler records: a CPU user annotation in
the same kineto trace as the kernels. Projection's backward is plain
autograd, run by the engine's own thread, where no span can open around
it: its nodes are found by the sequence number the profiler records on
each forward op and on the backward node it made, and put down to
`render/project` as `BACKWARD`.

`run.py` hands a reader the reduced trace (`trace.Trace`), which keeps no
timestamps. The spans need the profiler's raw events, which the run's
`trace.Tracer` still holds while the readers run: `of(ctx)` finds that
Tracer on the calling run's stack and reduces its events once a run
(`ctx["spans"]`, where given, is used instead). The first reduction
prints the idle-by-span and synchronisations-by-span tables on standard
error, before the run's `check` lines.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import sys
import time

from .trace import MIN_GAP_S, union_seconds

NO_SPAN = "(no span)"
BACKWARD = "render/project (backward)"
# The host stages of projection and binning, projection's backward nodes included.
PROJ_BIN = ("render/project", BACKWARD, "render/bin")
# The span of one counted unit of each kind of cell.
UNIT_SPAN = {"train": "train/step", "dagger": "pgd/iter"}
UNIT_WORD = {"train": "steps", "dagger": "iterations"}
# Runtime calls that wait for the device (a synchronous copy included).
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
EVALUATE = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class Spans:
    """A traced window's program spans: `spans` (start_ns, end_ns, name,
    thread), projection's backward nodes among them as `BACKWARD`; `syncs`
    (start_ns, runtime call); `gaps` the device's idle gaps over
    `MIN_GAP_S` (start_ns, end_ns); `idle` seconds of those gaps by the
    innermost span open over them; `synced` synchronisations by the
    innermost span open at their start; `device` whether the trace holds
    any device activity."""

    spans: list
    syncs: list
    gaps: list
    idle: dict
    synced: dict
    device: bool
    window_s: float


def reduce(events, window_s: float) -> Spans:
    """The profiler's raw events -> Spans, in one pass over them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, syncs, device, fwd, nodes = [], [], [], [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((s, s + e.duration_ns()))
            continue
        name = e.name()
        if e.is_user_annotation():
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), name, e.start_thread_id()))
        elif name in SYNC_CALLS:
            syncs.append((e.start_ns(), name))
        elif (seq := e.sequence_nr()) >= 0:  # an op that autograd recorded, or its node
            s = e.start_ns()
            if name.startswith(EVALUATE):
                nodes.append((s, s + e.duration_ns(), e.fwd_thread_id(), seq))
            else:
                fwd.append((s, e.start_thread_id(), seq))
    spans += _projection_backward(spans, fwd, nodes)
    gaps = _gaps(device)
    line = timeline(spans)
    idle = split(gaps, line)
    synced = {}
    for t, _ in syncs:
        who = owner_at(line, t)
        synced[who] = synced.get(who, 0) + 1
    return Spans(spans=spans, syncs=sorted(syncs), gaps=gaps, idle=idle, synced=synced,
                 device=bool(device), window_s=window_s)


def _projection_backward(spans, fwd, nodes) -> list:
    """The backward nodes whose forward op ran inside a `render/project`
    span on the same thread, as `BACKWARD` spans."""
    by_thread = {}
    for s, e, name, tid in spans:
        if name == "render/project":
            by_thread.setdefault(tid, []).append((s, e))
    for v in by_thread.values():
        v.sort()
    starts = {tid: [s for s, _ in v] for tid, v in by_thread.items()}
    made = set()
    for t, tid, seq in fwd:
        v = by_thread.get(tid)
        if v:
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t < v[i][1]:
                made.add((tid, seq))
    return [(s, e, BACKWARD, -1) for s, e, tid, seq in nodes if (tid, seq) in made]


def _gaps(device) -> list:
    """The device's idle gaps over MIN_GAP_S, as `trace.reduce_events`
    finds them: between one device interval's reach and the next start."""
    device.sort()
    out, reach = [], None
    for s, e in device:
        if reach is not None and s - reach > MIN_GAP_S * 1e9:
            out.append((reach, s))
        reach = e if reach is None else max(reach, e)
    return out


def timeline(spans) -> list:
    """Spans -> (start_ns, end_ns, name) segments, in order: over each
    segment the innermost span open on any host thread, the one that
    opened last, the shorter of two opened at once (on one thread spans
    nest, so that is the innermost; across threads it is the stage the
    host entered last, such as a backward node inside the step's
    backward)."""
    bounds = []
    for i, (s, e, _, _) in enumerate(spans):
        if e > s:
            bounds += [(s, 1, i), (e, 0, i)]
    bounds.sort()
    out, heap, ended = [], [], set()
    for k, (t, opens, i) in enumerate(bounds):
        if opens:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], i))
        else:
            ended.add(i)
        while heap and heap[0][2] in ended:
            heapq.heappop(heap)
        nxt = bounds[k + 1][0] if k + 1 < len(bounds) else t
        if heap and nxt > t:
            name = spans[heap[0][2]][2]
            if out and out[-1][2] == name and out[-1][1] == t:
                out[-1] = (out[-1][0], nxt, name)
            else:
                out.append((t, nxt, name))
    return out


def split(gaps, line) -> dict:
    """Seconds of each gap by the timeline's segment over it, split by
    overlap; what no segment covers goes to NO_SPAN."""
    out, j = {}, 0
    for gs, ge in gaps:
        while j < len(line) and line[j][1] <= gs:
            j += 1
        covered, k = 0, j
        while k < len(line) and line[k][0] < ge:
            s, e, name = line[k]
            part = min(e, ge) - max(s, gs)
            if part > 0:
                out[name] = out.get(name, 0.0) + part * 1e-9
                covered += part
            k += 1
        if ge - gs > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (ge - gs - covered) * 1e-9
    return out


def owner_at(line, t: int) -> str:
    """The timeline's span at time t, or NO_SPAN."""
    i = bisect.bisect_right(line, (t, float("inf"), "")) - 1
    return line[i][2] if i >= 0 and t < line[i][1] else NO_SPAN


def host_seconds(sp: Spans, names, unit: str) -> float:
    """Host seconds in the spans `names` (their union) that lie inside a
    `unit` span: the stages of the counted steps alone."""
    outer = sorted((s, e) for s, e, name, _ in sp.spans if name == unit)
    starts = [s for s, _ in outer]
    inside = []
    for s, e, name, _ in sp.spans:
        if name in names:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= outer[i][1]:
                inside.append((s, e))
    return union_seconds(inside)


def has(sp: Spans, names) -> bool:
    """Whether the program opened any of the spans `names` (a program
    without these spans, such as an older one, has none)."""
    return any(name in names for _, _, name, _ in sp.spans)


def of(ctx) -> Spans | None:
    """The traced window's Spans: `ctx["spans"]` if given, else the
    running `trace.Tracer`'s events, reduced once a run. None where no
    trace is found."""
    if "spans" in ctx:
        return ctx["spans"]
    tracer = _running_tracer()
    if tracer is None:
        return None
    global _cache
    if _cache is None or _cache[0] is not tracer.prof:
        t0 = time.perf_counter()
        events = tracer.prof.profiler.kineto_results.events()
        sp = reduce(events, ctx["trace"].window_s)
        _cache = (tracer.prof, sp)
        print(f"portbench: {len(events)} profiler events read for the spans in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        report(sp, ctx.get("kind"), ctx.get("units", 0))
    return _cache[1]


_cache = None  # (the profiler read, its Spans): the readers of one run share one pass


def _running_tracer():
    """The `trace.Tracer` of the run that called the reader: a local of a
    frame on the stack."""
    from .trace import Tracer

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Tracer) and v.prof is not None:
                return v
        f = f.f_back
    return None


def report(sp: Spans, kind, units: int) -> None:
    """The idle-by-span and synchronisations-by-span tables, on standard
    error, with the traced rate (units over the traced window)."""
    file = sys.stderr
    per = max(units, 1)
    idle = sum(sp.idle.values())
    named = idle - sp.idle.get(NO_SPAN, 0.0)
    print(f"portbench: traced {units} {UNIT_WORD.get(kind, 'units')} in {sp.window_s:.3f} s "
          f"({units / sp.window_s if sp.window_s else 0.0:.4f} a second); device idle gaps "
          f"{idle:.4f} s, {100 * named / idle if idle else 0.0:.2f}% of them in a program span",
          file=file)
    print("portbench: device idle by program span (s, % of the idle gaps, ms a unit):",
          file=file)
    for name, sec in sorted(sp.idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {sec:10.4f} {100 * sec / idle:7.2f}% {1e3 * sec / per:10.4f}",
              file=file)
    calls = {}
    for _, what in sp.syncs:
        calls[what] = calls.get(what, 0) + 1
    print(f"portbench: synchronisations by program span ({len(sp.syncs)} in all, "
          f"{len(sp.syncs) / per:.3f} a unit; {calls}):", file=file)
    for name, n in sorted(sp.synced.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {n:8d} {n / per:10.3f} a unit", file=file)
