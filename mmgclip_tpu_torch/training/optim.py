"""Optimizer and learning-rate schedules (port of mmgclip_tpu/training/optim.py).

AdamW with the semantics of ``optax.inject_hyperparams(optax.adamw)``, the
JAX package's optimizer, written in plain tensor ops so the update order is
optax's: the moments ``(1 - b)·g^k + b·m``, bias correction by
``1 - b^count`` (count after the increment), ``m̂ / (sqrt(v̂) + eps)``
(eps outside the square root), plus decoupled weight decay ``wd·p`` on every
leaf, all scaled by ``-lr``.  The rate and the decay are float32 scalars on
the parameters' device, so ``set_learning_rate`` changes the rate between
epochs without a host read (reference: ClassifierExperiment.py:74-82,
126; scheduler/warmup_cosine.py:8-61).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


class AdamW:
    """AdamW over a dict ``name -> Parameter``; ``trainable`` (same keys,
    bools) zeroes the update of frozen leaves, as the JAX package's
    ``optax.masked`` + ``set_to_zero`` chain does."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], learning_rate: float,
                 weight_decay: float, b1: float = B1, b2: float = B2, eps: float = EPS,
                 trainable: Optional[Dict[str, bool]] = None):
        self.params = params
        device = next(iter(params.values())).device
        self.trainable = trainable or {name: True for name in params}
        # as in optax: lr and wd are injected float32 scalars, b1/b2/eps plain
        # Python constants (weakly typed: (1 - 0.9) rounds once, to float32)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.hyperparams = {
            "learning_rate": torch.tensor(learning_rate, dtype=torch.float32, device=device),
            "weight_decay": torch.tensor(weight_decay, dtype=torch.float32, device=device)}
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = {name: torch.zeros_like(p) for name, p in params.items()}
        self.nu = {name: torch.zeros_like(p) for name, p in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        h = self.hyperparams
        self.count += 1
        count = self.count.to(torch.float32)
        c1 = 1 - torch.pow(self.b1, count)
        c2 = 1 - torch.pow(self.b2, count)
        for name, p in self.params.items():
            if not self.trainable[name]:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu = (1 - self.b1) * g + self.b1 * self.mu[name]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[name]
            self.mu[name], self.nu[name] = mu, nu
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + h["weight_decay"] * p
            p.add_(update * -h["learning_rate"])

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> Dict:
        """Host copy in the port's own layout (a tree of numpy arrays)."""
        def host(t):
            return t.detach().cpu().numpy()

        return {"count": host(self.count),
                "hyperparams": {k: host(v) for k, v in self.hyperparams.items()},
                "mu": {k: host(v) for k, v in self.mu.items()},
                "nu": {k: host(v) for k, v in self.nu.items()}}

    def load_state_dict(self, state: Dict) -> None:
        device = self.count.device
        self.count.fill_(int(state["count"]))
        for key, value in state["hyperparams"].items():
            self.hyperparams[key].fill_(float(value))
        for slot in ("mu", "nu"):
            target = getattr(self, slot)
            if set(state[slot]) != set(target):
                raise KeyError(f"optimizer state {slot} keys {sorted(state[slot])} != {sorted(target)}")
            for key, value in state[slot].items():
                target[key] = torch.as_tensor(np.asarray(value), device=device).to(target[key].dtype)


def create_optimizer(params: Dict[str, torch.nn.Parameter], learning_rate: float,
                     weight_decay: float, freeze_mask: Optional[Dict[str, bool]] = None) -> AdamW:
    """AdamW with runtime-settable lr.  ``freeze_mask``: name -> True when
    trainable (the ResNet layer4-only fine-tune)."""
    return AdamW(params, learning_rate, weight_decay, trainable=freeze_mask)


def resnet_finetune_mask(params: Dict[str, object]) -> Dict[str, bool]:
    """True = trainable.  Over dotted parameter names: freezes every
    ``image_encoder`` weight except the ``layer4`` stage
    (reference: mmgclip/networks/encoder.py:77-88)."""
    def keep(name: str) -> bool:
        keys = name.split(".")
        if keys[0] == "image_encoder":
            return any(k.startswith("layer4") for k in keys)
        return True

    return {name: keep(name) for name in params}


def set_learning_rate(optimizer: AdamW, lr: float) -> AdamW:
    """Overwrite the injected learning rate inside the optimizer state."""
    optimizer.hyperparams["learning_rate"].fill_(float(np.float32(lr)))
    return optimizer


class LinearWarmupCosineAnnealing:
    """Per-epoch multiplier: linear warmup, then cos^2 decay
    (reference: scheduler/warmup_cosine.py:41-61).  Float warmup_steps is a
    fraction of total (ceil), exactly as the reference."""

    def __init__(self, base_lr: float, total_steps: int, warmup_steps):
        assert warmup_steps < total_steps, "Warmup steps should be less than total steps."
        self.base_lr = base_lr
        self.tsteps = total_steps
        self.wsteps = math.ceil(total_steps * warmup_steps) if isinstance(warmup_steps, float) else warmup_steps

    def multiplier(self, step: int) -> float:
        if step < self.wsteps:
            return step / float(max(1, self.wsteps))
        cos_factor = (step - self.wsteps) / (self.tsteps - self.wsteps)
        return max(0.0, math.cos(cos_factor * (math.pi / 2)) ** 2)

    def lr_at(self, step: int) -> float:
        return self.base_lr * self.multiplier(step)


class ReduceLROnPlateau:
    """Min-mode plateau controller (reference: ClassifierExperiment.py:79-80)."""

    def __init__(self, base_lr: float, patience: int = 5, factor: float = 0.1, min_lr: float = 0.0):
        self.lr = base_lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.counter = 0

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.counter = 0
        return self.lr


def create_scheduler(config):
    """Config -> schedule object (reference: ClassifierExperiment.py:77-82)."""
    name = config.scheduler.name
    base_lr = float(config.optimizer.config.learning_rate)
    if name == "cosine":
        return LinearWarmupCosineAnnealing(
            base_lr,
            total_steps=int(config.scheduler.config.epochs),
            warmup_steps=config.scheduler.config.warmup_epochs,
        )
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base_lr, patience=int(config.scheduler.config.patience))
    raise ValueError(f"Unknown scheduler {name!r}")
