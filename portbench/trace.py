"""Host spans and the device trace of a traced run.

``Spans`` records the benchmark's own spans around its calls into each
layer of the port (host clock, any thread).  ``DeviceTrace`` wraps
``torch.profiler`` over CPU and CUDA activity in one or more sessions, marks
each session's window with a ``pb:window`` annotation, and reduces the
trace: the device's busy time (the union of its kernel, copy and set
intervals) inside the windows, their idle gaps named by the innermost
benchmark span they fall in, and the device time by kernel name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

PREFIX = "pb:"


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []  # list.append is atomic

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


class DeviceTrace:
    """Profiler sessions (``start`` / ``stop`` pairs); ``reduce()`` after the
    last ``stop()`` sums over them."""

    def __init__(self):
        self.prof = self._mark = None
        self.host_start = 0.0  # perf_counter at the open session's window annotation
        # per session: (window annotations, device events, host_start), times in ns
        self.sessions: List[Tuple[List[Tuple[int, int]], List[Tuple[str, int, int]], float]] = []

    def start(self) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self._mark = torch.profiler.record_function(PREFIX + "window")
        self._mark.__enter__()
        self.host_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self._collect()

    def _collect(self) -> None:
        from torch.autograd import DeviceType

        windows, device = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            try:
                start, end = e.start_ns(), e.end_ns()
            except AttributeError:  # older profilers count in microseconds
                start = int(e.start_us() * 1000)
                end = start + int(e.duration_us() * 1000)
            if name == PREFIX + "window":
                if e.device_type() == DeviceType.CPU:
                    windows.append((start, end))
            elif not name.startswith(PREFIX) and e.device_type() == DeviceType.CUDA:
                device.append((name, start, end))
        self.sessions.append((windows, device, self.host_start))
        self.prof = None

    def reduce(self, spans: Optional[Spans] = None) -> Optional[Dict]:
        """-> {window_s, busy_s, kernel_s: {name: s}, idle_gaps: [(label, s)]}
        summed over the sessions, or None without a window or device activity.
        Gaps are named by the innermost of ``spans``' records they fall in
        (host clock, moved onto the trace's clock by the session's window
        annotation)."""
        window_s = busy_s = 0.0
        kernel_s: Dict[str, float] = {}
        gaps = []
        for windows, device, host_start in self.sessions:
            if not windows:
                continue
            w0, w1 = min(s for s, _ in windows), max(e for _, e in windows)
            inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
            busy = _union([(s, e) for _n, s, e in inside])
            window_s += (w1 - w0) / 1e9
            busy_s += sum(e - s for s, e in busy) / 1e9
            for n, s, e in inside:
                kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e9
            shift = w0 - int(host_start * 1e9)
            host = [(n, int(t0 * 1e9) + shift, int(t1 * 1e9) + shift)
                    for n, t0, t1 in ([] if spans is None else spans.records) if n != "window"]
            edges = [(w0, w0)] + busy + [(w1, w1)]
            for (_a, end), (start, _b) in zip(edges[:-1], edges[1:]):
                if start > end:
                    mid = (start + end) // 2
                    covering = [(e - s, n) for n, s, e in host if s <= mid <= e]
                    gaps.append((min(covering)[1] if covering else "between spans",
                                 (start - end) / 1e9))
        if window_s <= 0 or not kernel_s:
            return None
        return {"window_s": window_s, "busy_s": busy_s, "kernel_s": kernel_s, "idle_gaps": gaps}


def breakdown(reduced: Dict) -> Dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the benchmark span it fell in."""
    ops = sorted(reduced["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(reduced["idle_gaps"], key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
