"""Profiling / tracing hooks (port of mmgclip_tpu/utils/profiling.py).

``maybe_trace`` wraps a region in a ``torch.profiler`` trace when enabled
(CPU activity, plus CUDA when a card is present) and writes a Chrome trace
under the given directory.  ``StepTimer`` records per-step wall time,
fenced on the device of the step's outputs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def maybe_trace(enabled: bool, logdir: str) -> Iterator[None]:
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{int(time.time())}.json"))



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
