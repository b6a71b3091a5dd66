"""Scalar metric logging (port of mmgclip_tpu/utils/tb.py).

TensorBoard scalars matching the reference tag set
(reference: ClassifierExperiment.py:90,130,233,241,256,271,276,320) plus a
JSONL mirror that always works.  The TensorBoard event writer is tried and
skipped when ``torch.utils.tensorboard`` does not import (it needs the
``tensorboard`` package, which a machine may lack)."""

from __future__ import annotations

import json
import os
import time

from .seeding import create_directory_if_not_exists


class ScalarWriter:
    def __init__(self, log_dir: str):
        self.log_dir = create_directory_if_not_exists(log_dir)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:  # tensorboard is optional, as in the JAX package
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def read_scalars(log_dir: str) -> dict:
    """``scalars.jsonl`` -> {tag: [values in step order]} (last write per step)."""
    by_tag: dict = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            by_tag.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return {tag: [steps[s] for s in sorted(steps)] for tag, steps in by_tag.items()}
