"""Profiling and tracing (port of mmgclip_tpu/utils/profiling.py, plus the
port's tracer).

``maybe_trace`` wraps a region in a ``torch.profiler`` trace when enabled
(CPU activity, plus CUDA when a card is present) and writes, under the given
directory, the Chrome trace (``trace_<t>.json``) and the spans recorded in
the session on the profiler's clock (``spans_<t>.json``: ``{"clock",
"anchor", "spans"}``, each span with ``start_ns`` / ``end_ns`` in Unix-epoch
nanoseconds, as the profiler stamps its events).  ``StepTimer`` records
per-step wall time, fenced on the device of the step's outputs.

The tracer.  A span is a named interval: start and end in
``time.perf_counter_ns()``, the thread (or device) it ran on, its parent
span's id, and a few attributes (batch id, rows, bytes).  Records are dicts
``{"id", "name", "start_ns", "end_ns", "thread", "parent", "attrs"}``.

* Recording is on exactly while a ``torch.profiler`` session is active on
  the calling thread (``tracing()``; ``maybe_trace``, an operator's own
  profiler, a benchmark's traced run): no switch of its own.  A caller takes
  ``recorder()`` once per coarse call, ``TRACER`` or ``INERT`` (the same calls,
  recording nothing and calling no callable attribute), and calls it
  unconditionally.  The profiler's state is thread-local (a pool worker reads
  it as off, and a ``record_function`` entered there is not recorded), so
  worker threads take the caller's tracer and record spans with ``add``.
* Spans opened with ``Tracer.begin`` on the calling thread also open a
  profiler range ``"mmg:" + name``, so they sit in the profiler's own trace
  beside the device's kernels.  The range has function scope
  (``_RecordFunctionFast``), not ``record_function``'s user scope: the
  profiler gives each user-scope range a ``gpu_user_annotation`` on the
  device's timeline over the kernels launched inside it, which a reduction
  of the device's busy intervals would count as device work.  The tracer keeps one
  anchor pair ``(perf_counter_ns, time_ns)``, read when a root span begins,
  and ``to_profiler_clock`` moves any span, a worker's too, onto the
  profiler's clock with it.  ``Tracer.current()`` is the innermost span
  the calling thread has open: a callee (a tower inside a bank chunk)
  records its spans under it without the caller handing it down.
* Device spans: ``Tracer.mark(device)`` records a CUDA event on the
  device's current stream, and ``Tracer.interval`` waits for a second mark
  and records the span between them; a ``DeviceClock``, built at a device's
  first mark after a root span begins, resolves them onto the host clock.
  A callee hands marks up to its caller through ``Tracer.collect``.
* Records are kept in memory, at most ``MAX_SPANS`` (65,536) of them: past
  that the oldest are dropped.  ``spans()`` reads them back, ``reset_spans()``
  clears them (``TRACER``, the process's tracer).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import torch

MAX_SPANS = 65536
PREFIX = "mmg:"


def tracing() -> bool:
    """True while a ``torch.profiler`` session is active on this thread."""
    return torch._C._autograd._profiler_enabled()


class Span:
    """An open span (``Tracer.begin``); ``id`` is its records' parent id."""

    __slots__ = ("id", "name", "start_ns", "parent", "attrs", "_mark")

    def __init__(self, id: int, name: str, start_ns: int, parent: Optional[int], attrs: Dict,
                 mark):
        self.id, self.name, self.start_ns = id, name, start_ns
        self.parent, self.attrs, self._mark = parent, attrs, mark


def _id(span) -> Optional[int]:
    return span.id if isinstance(span, Span) else span


class Tracer:
    """Spans in a bounded in-memory buffer (module docstring)."""

    def __init__(self, capacity: int = MAX_SPANS):
        self._records: deque = deque(maxlen=capacity)  # append is atomic, drops the oldest
        self._ids = itertools.count(1)  # next() is atomic
        self.anchor: Optional[Tuple[int, int]] = None  # (perf_counter_ns, time_ns)
        self._clocks: Dict[torch.device, DeviceClock] = {}  # since the last root span began
        self._open = threading.local()  # .spans: this thread's open spans, innermost last

    def begin(self, name: str, parent=None, start_ns: Optional[int] = None, **attrs) -> Span:
        """Open a span on this thread (also entered as an ``mmg:`` profiler
        event); ``start_ns`` is a ``perf_counter_ns()`` reading the caller
        already took.  A root span (no parent) refreshes the anchor pair and
        the device clocks."""
        if parent is None:
            self.anchor, self._clocks = (time.perf_counter_ns(), time.time_ns()), {}
        mark = torch._C._profiler._RecordFunctionFast(PREFIX + name)
        mark.__enter__()
        start = time.perf_counter_ns() if start_ns is None else start_ns
        span = Span(next(self._ids), name, start, _id(parent), attrs, mark)
        self._stack().append(span)
        return span

    def end(self, span: Span, end_ns: Optional[int] = None, **attrs) -> int:
        """Close ``span`` (``end_ns``: a reading the caller already took) and
        record it, with ``attrs`` added to its attributes; -> its end
        reading, for a span that starts where this one ends."""
        end = time.perf_counter_ns() if end_ns is None else end_ns
        span._mark.__exit__(None, None, None)
        stack = self._stack()
        if span in stack:
            stack.remove(span)
        self._append(span.id, span.name, span.start_ns, end, threading.current_thread().name,
                     span.parent, {**span.attrs, **attrs})
        return end

    def current(self) -> Optional[Span]:
        """The innermost span this thread has open (``begin`` without
        ``end``), or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _stack(self) -> List[Span]:
        if not hasattr(self._open, "spans"):
            self._open.spans = []
        return self._open.spans

    def add(self, name: str, start_ns: int, end_ns: int, parent=None, thread: Optional[str] = None,
            **attrs) -> int:
        """Record a finished span from readings taken elsewhere (a worker
        thread, a device); -> its id."""
        span_id = next(self._ids)
        self._append(span_id, name, start_ns, end_ns,
                     thread or threading.current_thread().name, _id(parent), attrs)
        return span_id

    def mark(self, device) -> Optional[Tuple["DeviceClock", torch.cuda.Event]]:
        """An event recorded now on ``device``'s current stream, and its
        clock; None off the card."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        if device not in self._clocks:
            self._clocks[device] = DeviceClock(device)
        return self._clocks[device], self._clocks[device].mark()

    def interval(self, name: str, begin, end, parent=None, **attrs) -> Optional[int]:
        """Wait for ``end`` and record the span from ``begin`` to it (``mark``s
        of one device) on the device's thread; -> its id.  Marks off the card
        record nothing.  After a read-back that passed ``end``, the wait is free."""
        if end is None:
            return None
        end[1].synchronize()
        return self.add(name, begin[0].resolve(begin[1]), end[0].resolve(end[1]), parent,
                        thread=str(end[0].device), **attrs)

    def collecting(self) -> List:
        """A new list, to which this thread's ``collect`` calls append until
        its next ``collecting()``."""
        self._open.kept = []
        return self._open.kept

    def collect(self, item) -> None:
        getattr(self._open, "kept", []).append(item)

    def _append(self, span_id, name, start_ns, end_ns, thread, parent, attrs) -> None:
        self._records.append({"id": span_id, "name": name, "start_ns": int(start_ns),
                              "end_ns": int(end_ns), "thread": thread, "parent": parent,
                              "attrs": {k: v() if callable(v) else v for k, v in attrs.items()}})

    def spans(self) -> List[Dict]:
        return list(self._records)

    def reset(self) -> None:
        self._records.clear()

    def to_profiler_clock(self, records: List[Dict]) -> List[Dict]:
        """``records`` with their times moved onto the profiler's clock
        (Unix-epoch ns) by the anchor pair."""
        if self.anchor is None:
            self.anchor = (time.perf_counter_ns(), time.time_ns())
        shift = self.anchor[1] - self.anchor[0]
        return [dict(r, start_ns=r["start_ns"] + shift, end_ns=r["end_ns"] + shift)
                for r in records]


TRACER = Tracer()


class InertTracer:
    """``Tracer``'s calls while no profiler records: nothing is recorded,
    no callable attribute called, no device marked."""

    def begin(self, *_args, **_attrs) -> None:
        return None

    end = add = current = mark = interval = collecting = collect = begin


INERT = InertTracer()


def recorder():
    """``TRACER`` while ``tracing()`` is on, else ``INERT``."""
    return TRACER if tracing() else INERT


def spans() -> List[Dict]:
    """The process tracer's records, oldest first."""
    return TRACER.spans()


def reset_spans() -> None:
    TRACER.reset()


class DeviceClock:
    """Device events on ``device``'s current stream, resolved onto the host
    clock (module docstring).  The constructor synchronizes the device, then
    records the anchor event and waits for it (``Tracer.mark`` builds them)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        self._anchor = torch.cuda.Event(enable_timing=True)
        self._anchor.record(self.stream)
        self.anchor_ns = time.perf_counter_ns()  # the idle stream stamps the event at once
        self._anchor.synchronize()

    def mark(self) -> torch.cuda.Event:
        """An event recorded now on the stream."""
        event = torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        return event

    def resolve(self, event: torch.cuda.Event) -> int:
        """The completed ``event``'s time as a ``perf_counter_ns()`` reading."""
        return self.anchor_ns + round(self._anchor.elapsed_time(event) * 1e6)


@contextlib.contextmanager
def maybe_trace(enabled: bool, logdir: str) -> Iterator[None]:
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    opened = time.perf_counter_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    stamp = int(time.time())
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{stamp}.json"))
    session = TRACER.to_profiler_clock([r for r in TRACER.spans() if r["start_ns"] >= opened])
    with open(os.path.join(logdir, f"spans_{stamp}.json"), "w", encoding="utf-8") as fh:
        json.dump({"clock": "profiler: Unix-epoch ns", "anchor": TRACER.anchor, "spans": session}, fh)


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _cuda_devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _cuda_devices(value, found)
    return found


class StepTimer:
    """Wall-clock step timing; ``stop(fence)`` first waits for the device of
    every CUDA tensor in ``fence`` (a tensor or a tree of them), as JAX's
    ``block_until_ready`` waits for its arrays."""

    def __init__(self):
        self.times: List[float] = []
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, fence=None) -> float:
        for device in _cuda_devices(fence, set()):
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - self._start
        self.times.append(elapsed)
        return elapsed

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
