"""Early stopping + best-checkpoint export (port of
mmgclip_tpu/training/early_stopping.py; reference:
mmgclip/callbacks/early_stopping.py:6-66)."""

from __future__ import annotations

from typing import Callable, Optional

from ..utils.logging import logger
from .checkpoint import save_checkpoint


class EarlyStopper:
    def __init__(self, patience: int = 5, delta: float = 0.0, trace_func: Callable = logger.warning):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.val_loss_min = float("inf")
        self.trace_func = trace_func

    def __call__(self, validation_loss: float, epoch: int, params, opt_state, path: str,
                 rng_key=None, extra=None):
        """``params`` / ``opt_state`` / ``rng_key``: callables returning the
        host copies, so nothing leaves the card unless a checkpoint is written."""
        score = -validation_loss
        if self.best_score is None or score >= self.best_score + self.delta:
            self.best_score = score
            # reset BEFORE saving: the checkpoint persists `counter`
            self.counter = 0
            self._save(validation_loss, epoch, params, opt_state, path, rng_key, extra)
        else:
            self.counter += 1
            self.trace_func(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True

    def _save(self, val_loss, epoch, params, opt_state, path, rng_key, extra=None):
        self.trace_func(
            f"Valid loss improved from {self.val_loss_min:.6f} to {val_loss:.6f}. Saving model ..."
        )
        host = (params(), opt_state() if opt_state else None, rng_key() if rng_key else None)
        paths = [path]
        if epoch != 0 and epoch % 100 == 0:
            # periodic snapshot every 100 epochs (reference: early_stopping.py:63-65)
            paths.append(path.replace("model.msgpack", f"{epoch}_model.msgpack"))
        for target in paths:
            save_checkpoint(target, host[0], host[1], epoch=epoch, val_loss=val_loss,
                            best_score=self.best_score, counter=self.counter, rng_key=host[2],
                            extra=extra)
        self.val_loss_min = val_loss
