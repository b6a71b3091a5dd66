"""Optimizer and learning-rate schedules (port of mmgclip_tpu/training/optim.py).

AdamW with the semantics of ``optax.inject_hyperparams(optax.adamw)``, the
JAX package's optimizer, written in plain tensor ops so the update order is
optax's: the moments ``(1 - b)·g^k + b·m``, bias correction by
``1 - b^count`` (count after the increment), ``m̂ / (sqrt(v̂) + eps)``
(eps outside the square root), plus decoupled weight decay ``wd·p`` on every
leaf, all scaled by ``-lr``.  The rate and the decay are float32 scalars on
the parameters' device, so ``set_learning_rate`` changes the rate between
epochs without a host read (reference: ClassifierExperiment.py:74-82,
126; scheduler/warmup_cosine.py:8-61).  Every state tensor is updated in
place, so a CUDA graph captured over ``step`` replays against the live
moments, count and rate.
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
            # in place: a captured CUDA graph keeps reading these buffers
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + h["weight_decay"] * p
            p.add_(update * -h["learning_rate"])

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> Dict:
        """Host copy in the port's own layout (a tree of numpy arrays); a
        frozen name's moments are empty dicts, as optax's ``MaskedNode``
        leaves are in the masked chain's state."""
        def host(t):
            return t.detach().cpu().numpy()

        def moments(slot):
            return {k: host(v) if self.trainable[k] else {} for k, v in slot.items()}

        return {"count": host(self.count),
                "hyperparams": {k: host(v) for k, v in self.hyperparams.items()},
                "mu": moments(self.mu), "nu": moments(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        """Copies into the live tensors (a captured graph reads those).  A
        frozen name's moments may be an empty dict or absent: they are
        zeroed, and the update never reads them."""
        self.count.fill_(int(state["count"]))
        for key, value in state["hyperparams"].items():
            self.hyperparams[key].fill_(float(value))
        for slot in ("mu", "nu"):
            target = getattr(self, slot)
            given = {k: v for k, v in state[slot].items() if not isinstance(v, dict)}
            trainable = {k for k in target if self.trainable[k]}
            if not (trainable <= set(given) and set(state[slot]) <= set(target)):
                raise KeyError(f"optimizer state {slot} keys {sorted(state[slot])} do not cover "
                               f"the trainable {sorted(trainable)} within {sorted(target)}")
            for key, tensor in target.items():
                if key not in given:
                    tensor.zero_()
                    continue
                value = torch.as_tensor(np.asarray(given[key]))
                if tuple(value.shape) != tuple(tensor.shape):
                    raise ValueError(f"optimizer state {slot}.{key}: shape {tuple(value.shape)} "
                                     f"!= {tuple(tensor.shape)}")
                tensor.copy_(value)


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
