"""The traced window: the harness's spans and the device's trace.

``Tracer`` puts a span around each call the benchmark's side makes into
a layer of the program (``query``: ``Executor.run``; ``graph.prepare``:
the backend's placement of the graph; ``driver.chunk``: one chunk the
driver hands the backend) and, as a context, records what runs inside
it with ``torch.profiler``: ``TRACED_QUERIES`` queries that follow the
measured window, so that neither the profiler's cost nor the reading of
its trace lands in the window. ``summarize`` reduces the trace to what the metric
readers and the result's breakdown take: the device's busy seconds (the
union of its kernel, copy and set intervals), device seconds by kernel,
the ten operations that took most, and the ten longest idle totals named
by what the host was doing halfway through each idle gap.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPANS = ("query", "graph.prepare", "driver.chunk")
WINDOW = "bench.window"
#: queries traced after the window: every query of a cell does the same
#: work, and two keep the trace's reading well inside a run's time
TRACED_QUERIES = 2


def kernel_name(key: str) -> str:
    """A profiler key cut to the kernel's name: no return type, no
    anonymous namespace, no argument list."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:80]


def _wrap(obj, attr: str, span: str) -> None:
    from torch.profiler import record_function
    inner = getattr(obj, attr)

    def traced(*args, **kwargs):
        with record_function(span):
            return inner(*args, **kwargs)

    setattr(obj, attr, traced)


class Tracer:
    """Spans on one executor and a profiler over the window."""

    def __init__(self, executor, device):
        from torch.profiler import ProfilerActivity, profile
        _wrap(executor, "run", "query")
        _wrap(executor.backend, "prepare", "graph.prepare")
        _wrap(executor.backend, "run_chunk", "driver.chunk")
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, acc_events=True)
        self.window_s = 0.0

    def __enter__(self):
        from torch.profiler import record_function
        self.prof.__enter__()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)

    def summarize(self) -> dict:
        from torch.autograd import DeviceType
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        bounds = None
        for e in self.prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.name == WINDOW:
                if e.device_type != DeviceType.CUDA:
                    bounds = (t0, t1)
            elif e.name in SPANS:
                # a span shows on the device's timeline too: keep the host's
                if e.device_type != DeviceType.CUDA:
                    host.append((t0, t1, e.name))
            elif e.device_type == DeviceType.CUDA:
                dev.append((t0, t1, kernel_name(e.name)))
            else:
                host.append((t0, t1, e.name))
        by_name: Dict[str, float] = defaultdict(float)
        for t0, t1, name in dev:
            by_name[name] += (t1 - t0) / 1e6
        busy, gaps = _busy_and_gaps(dev, bounds)
        return {"busy_s": busy, "window_s": self.window_s,
                "kernel_s": dict(by_name),
                "device_ops": top(by_name.items()),
                "idle_gaps": top(_name_gaps(gaps, host).items())}


def top(items, k: int = 10) -> List[list]:
    return [[n, s] for n, s in sorted(items, key=lambda x: -x[1])[:k]]


def _busy_and_gaps(dev, bounds) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds covered by the device intervals, and the gaps between them
    inside ``bounds`` (microseconds)."""
    busy = 0.0
    gaps = []
    if not dev:
        return 0.0, gaps
    ivs = sorted((t0, t1) for t0, t1, _ in dev)
    lo = bounds[0] if bounds else ivs[0][0]
    hi = bounds[1] if bounds else ivs[-1][1]
    cur0, cur1 = ivs[0]
    if cur0 > lo:
        gaps.append((lo, cur0))
    for t0, t1 in ivs[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    if hi > cur1:
        gaps.append((cur1, hi))
    return busy / 1e6, gaps


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by ``span > op``: the innermost harness span and the
    innermost other host event open halfway through each gap."""
    mids = [(g0 + g1) / 2 for g0, g1 in gaps]
    span = _innermost(sorted(h for h in host if h[2] in SPANS), mids)
    op = _innermost(sorted(h for h in host if h[2] not in SPANS), mids)
    out: Dict[str, float] = defaultdict(float)
    for (g0, g1), s, o in zip(gaps, span, op):
        s = s or "outside queries"
        out[f"{s} > {o}" if o else s] += (g1 - g0) / 1e6
    return out


def _innermost(events, times) -> List[Optional[str]]:
    """For each of ``times`` (ascending), the latest-starting of
    ``events`` (sorted by start; nested, as one thread's are) open then:
    one sweep with a stack of the open events."""
    out: List[Optional[str]] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out
