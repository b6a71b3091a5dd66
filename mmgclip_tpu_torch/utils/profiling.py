"""Profiling / tracing hook (port of ``maybe_trace`` of
mmgclip_tpu/utils/profiling.py).

``maybe_trace`` wraps a region in a ``torch.profiler`` trace when enabled
(CPU activity, plus CUDA when a card is present) and writes a Chrome trace
under the given directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

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

