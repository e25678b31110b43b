"""Spans and counters of the port's enumeration path, kept in memory.

Tracing is on inside :func:`recording` (an operator's, or the enumerate
CLI's ``--trace PATH``) and while a ``torch.profiler`` records. Off, each
site makes one check (:func:`on` in ``drive``, :func:`current` or
:func:`span` below it) and nothing more: no profiler range, no CUDA
event, no tensor op, no host read, no key in ``ExecStats.extras``.

On, ``drive`` keeps one :class:`Recorder` a query:

* **spans**: name, start and end in ns, the index of the parent span in
  the query's list (-1 for the root), the query's id and attributes. The
  times are ``time.time_ns()``, the realtime clock on which the profiler
  stamps its host events, so a span and a gap of the device's timeline
  compare directly. Each span also opens a profiler range of its name:
  under ``torch.profiler`` it lands on the host timeline and encloses the
  ops it issues. The range is of the function kind
  (``_RecordFunctionFast``): a user range (``record_function``) is also
  mirrored onto the device's timeline, where a reader of device intervals
  would count it as device work.
* **counters**: each chunk's device ms, summed by its outcome (accepted,
  split, retried); ENU's flags scanned and valid candidates, per level
  and outcome, and the flags of the levels that ran count-only; the
  fused gather-intersect kernel's valid entries of ``cand`` and of the
  adjacency rows it gathers. Counts on the device are
  summed there during a chunk and read with the chunk's one read-back
  (:meth:`Recorder.head`, :meth:`Recorder.settle`). Only a backend that
  reads them back (``TorchBackend``) sets :attr:`Recorder.counts`; under
  any other, :func:`counting` is ``None`` and no site queues device work.

``drive`` writes ``ExecStats.extras["trace"] = {"spans": [...],
"counters": {...}}``; :func:`to_chrome` writes spans as Chrome
trace-event JSON and :func:`self_times` sums each name's self time.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

OUTCOMES = ("accepted", "split", "retried")
#: per ENU level, in the order a chunk's levels run
ENU_KEYS = ("flags", "valid")
#: per ENU level too: the flags a level scanned where it ran count-only
#: (its child frontier never built, core/engine_torch.py), else 0
COUNTED = "counted"
#: per kernel: valid entries of the candidates and of the other operand
KERNEL_KEYS = ("cand_valid", "adj_valid")

#: a context that does nothing: what a site enters when tracing is off
NULL = nullcontext()

_QUERY: ContextVar[Optional["Recorder"]] = ContextVar(
    "repro_torch_trace_query", default=None)
_RECORDINGS: ContextVar[Tuple["Recording", ...]] = ContextVar(
    "repro_torch_trace_recordings", default=())
_QUERY_IDS = itertools.count()


def on() -> bool:
    """Whether a query that starts now is traced."""
    return bool(_RECORDINGS.get()) or torch.autograd._profiler_enabled()


def current() -> Optional["Recorder"]:
    """The running query's recorder; ``None`` when tracing is off."""
    return _QUERY.get()


def counting() -> Optional["Recorder"]:
    """The running query's recorder where its backend reads the device
    counters back; ``None`` otherwise."""
    rec = _QUERY.get()
    return rec if rec is not None and rec.counts else None


def span(name: str, **attrs):
    """A span of the running query, or :data:`NULL` when tracing is
    off."""
    rec = _QUERY.get()
    return NULL if rec is None else rec.span(name, **attrs)


class Recording:
    """What :func:`recording` collects: each traced query's export, in
    the order the queries ended."""

    def __init__(self):
        self.queries: List[dict] = []

    @property
    def spans(self) -> List[dict]:
        return [s for q in self.queries for s in q["spans"]]


@contextmanager
def recording() -> Iterator[Recording]:
    """Trace every query that runs inside."""
    rec = Recording()
    token = _RECORDINGS.set(_RECORDINGS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDINGS.reset(token)


@contextmanager
def query(**attrs) -> Iterator["Recorder"]:
    """A query's recorder, current inside, under its ``exec.query``
    span; its export goes to every open :func:`recording`."""
    rec = Recorder(next(_QUERY_IDS))
    token = _QUERY.set(rec)
    try:
        with rec.span("exec.query", **attrs):
            yield rec
    finally:
        _QUERY.reset(token)
    for r in _RECORDINGS.get():
        r.queries.append(rec.export())


class _Span:
    """One span: entered, it appends its record to the query's list and
    opens its profiler range; left, it stamps its end."""

    __slots__ = ("recorder", "record", "_range")

    def __init__(self, recorder: "Recorder", name: str, attrs: dict):
        self.recorder = recorder
        self.record = {"name": name, "start_ns": 0, "end_ns": 0,
                       "parent": -1, "query": recorder.query,
                       "attrs": attrs}

    def __enter__(self) -> dict:
        r, rec = self.recorder, self.record
        if r.open:
            rec["parent"] = r.open[-1]
        r.open.append(len(r.spans))
        r.spans.append(rec)
        self._range = _RecordFunctionFast(rec["name"])
        self._range.__enter__()
        # read right after the range's own stamp: nothing that allocates
        # (and so may collect garbage) runs between the two
        rec["start_ns"] = time.time_ns()
        return rec

    def __exit__(self, *exc) -> None:
        self.record["end_ns"] = time.time_ns()
        self._range.__exit__(*exc)
        self.recorder.open.pop()


class Recorder:
    """One query's spans and counters (the module's docstring says what
    each is)."""

    def __init__(self, query_id: int):
        self.query = query_id
        self.spans: List[dict] = []
        self.open: List[int] = []            # indices of open spans
        self.device_ms: Dict[str, float] = dict.fromkeys(OUTCOMES, 0.0)
        self.enu: Dict[str, Dict[str, List[int]]] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        #: set by a backend that stacks :meth:`head` into its chunk's
        #: read-back and hands the values to :meth:`settle`
        self.counts = False
        self._new_chunk()

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    # ---- the open chunk

    def _new_chunk(self) -> None:
        self._levels: List[Tuple[int, torch.Tensor, int]] = []
        self._kernel_dev: Dict[str, torch.Tensor] = {}
        self._settled: Optional[Tuple[list, Dict[str, list]]] = None
        self._clock: Optional[Tuple[torch.cuda.Event,
                                    torch.cuda.Event]] = None
        self._chunk_ms: Optional[float] = None

    def enu_level(self, flags: int, valid: torch.Tensor,
                  count_only: bool = False) -> None:
        """An ENU level of the chunk: flags scanned, the device scalar of
        its valid candidates, and whether it ran count-only."""
        self._levels.append((flags, valid, flags if count_only else 0))

    def kernel(self, name: str, valid: torch.Tensor) -> None:
        """A launch of kernel ``name``: ``valid`` = int64[2] on the
        device, the valid entries of the candidates and of the other
        operand."""
        acc = self._kernel_dev.get(name)
        self._kernel_dev[name] = valid if acc is None else acc + valid

    def start_device_clock(self, device: torch.device) -> None:
        """A CUDA event before the chunk's first op (on a card)."""
        if device.type == "cuda":
            self._clock = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self._clock[0].record()

    def stop_device_clock(self) -> None:
        """A CUDA event after the chunk's last op, before its read-back:
        the read-back completes it, so reading it adds no sync."""
        if self._clock is not None:
            self._clock[1].record()

    def head(self) -> List[torch.Tensor]:
        """The chunk's device scalars, to stack into its read-back."""
        out = [valid for _, valid, _ in self._levels]
        for acc in self._kernel_dev.values():
            out.extend(acc.unbind())
        return out

    def settle(self, values: Sequence[int]) -> None:
        """The values of :meth:`head`, read back with the chunk."""
        it = iter(values)
        levels = [(flags, next(it), counted)
                  for flags, _, counted in self._levels]
        kernels = {name: [next(it) for _ in KERNEL_KEYS]
                   for name in self._kernel_dev}
        self._settled = (levels, kernels)
        if self._clock is not None:
            self._chunk_ms = self._clock[0].elapsed_time(self._clock[1])

    def end_chunk(self, chunk: _Span, outcome: str) -> None:
        """Book the chunk that ``chunk`` spanned under ``outcome``: its
        device ms (the events' where a backend timed it, else the span's
        wall time) and, where read back, its ENU and kernel counts."""
        rec = chunk.record
        ms = self._chunk_ms if self._chunk_ms is not None else \
            (rec["end_ns"] - rec["start_ns"]) / 1e6
        rec["attrs"].update(outcome=outcome, device_ms=ms)
        self.device_ms[outcome] += ms
        if self._settled is not None:
            levels, kernels = self._settled
            keys = ENU_KEYS + (COUNTED,)
            enu = self.enu.setdefault(outcome, {k: [] for k in keys})
            for i, level in enumerate(levels):
                for key, v in zip(keys, level):
                    col = enu[key]
                    if len(col) == i:
                        col.append(0)
                    col[i] += int(v)
            for name, dev in kernels.items():
                k = self.kernels.setdefault(name,
                                            dict.fromkeys(KERNEL_KEYS, 0))
                for key, v in zip(KERNEL_KEYS, dev):
                    k[key] += int(v)
        self._new_chunk()

    def export(self) -> dict:
        return {"spans": self.spans,
                "counters": {"device_ms": dict(self.device_ms),
                             "enu": self.enu, "kernels": self.kernels}}


# --------------------------------------------------------------------------
# Reading spans
# --------------------------------------------------------------------------


def self_times(spans: Sequence[dict]) -> Dict[str, float]:
    """Seconds by span name of each span less its children (a span's
    children run one after another inside it)."""
    kids: Dict[Tuple[int, int], int] = defaultdict(int)
    for s in spans:
        if s["parent"] >= 0:
            kids[(s["query"], s["parent"])] += s["end_ns"] - s["start_ns"]
    out: Dict[str, float] = defaultdict(float)
    first: Dict[int, int] = {}
    for i, s in enumerate(spans):
        base = first.setdefault(s["query"], i)   # a query's spans in a row
        own = s["end_ns"] - s["start_ns"] - kids[(s["query"], i - base)]
        out[s["name"]] += own / 1e9
    return dict(out)


def to_chrome(spans: Sequence[dict], path=None) -> dict:
    """Chrome trace-event JSON of ``spans`` (one row a query, times in
    µs of the realtime clock); written to ``path`` when given."""
    pid = os.getpid()
    doc = {"displayTimeUnit": "ms", "traceEvents": [
        {"name": s["name"], "ph": "X", "ts": s["start_ns"] / 1e3,
         "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "pid": pid,
         "tid": s["query"], "args": s["attrs"]} for s in spans]}
    if path is not None:
        Path(path).write_text(json.dumps(doc))
    return doc
