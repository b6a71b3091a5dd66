"""ZeRO-1: the AdamW moments sharded over the data axis (port of
mmgclip_tpu/parallel/zero.py).

Each moment tensor is split on its first axis that the data size divides
(``_leaf_axis``, the JAX package's ``_leaf_spec``); a leaf with no such axis
and the count and hyperparameters stay whole on every rank.  Where the JAX
package leaves the reduce-scatter / all-gather pair to GSPMD, ``ZeroAdamW``
writes it out: each step reduce-scatters a sharded leaf's gradient over
``data``, updates this rank's block of the moments and of the parameter,
and all-gathers the parameter; a whole leaf's gradient is all-reduced and
updated as AdamW does.  The arithmetic per element is AdamW's own
(``AdamW._delta``), so a step equals the replicated one up to the order of
the gradient sums.
Checkpoints hold the whole moments in optax's layout (``state_dict``
gathers them, ``load_state_dict`` keeps this rank's block), so they cross
with unsharded runs of either package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..training.optim import AdamW
from .collectives import _all_gather_raw, _all_reduce_raw, _reduce_scatter_raw
from .mesh import DATA_AXIS, Mesh, NamedSharding, PartitionSpec as P


def _leaf_axis(shape, n_shards: int) -> Optional[int]:
    """The first axis that ``n_shards`` divides, or None (the leaf stays whole)."""
    if n_shards <= 1:
        return None
    for axis, dim in enumerate(shape):
        if dim % n_shards == 0 and dim >= n_shards:
            return axis
    return None


def zero1_shardings(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, NamedSharding]:
    """name -> placement of that leaf's moments: split over ``data`` on its
    first divisible axis, else whole."""
    n = mesh.size(DATA_AXIS)
    out = {}
    for name, leaf in params.items():
        axis = _leaf_axis(tuple(leaf.shape), n)
        spec = P() if axis is None else P(*([None] * axis), DATA_AXIS)
        out[name] = NamedSharding(mesh, spec)
    return out


def shard_opt_state(state: Dict, mesh: Mesh) -> Dict:
    """This rank's blocks of an ``AdamW.state_dict()`` (whole moments)."""
    shardings = zero1_shardings({k: v for k, v in state["mu"].items() if not isinstance(v, dict)}, mesh)

    def blocks(slot):
        return {k: v if isinstance(v, dict) else v[shardings[k].block(v.shape)] for k, v in slot.items()}

    return {**state, "mu": blocks(state["mu"]), "nu": blocks(state["nu"])}


def _narrow(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    n = mesh.size(DATA_AXIS)
    size = t.shape[axis] // n
    return t.narrow(axis, mesh.index(DATA_AXIS) * size, size)


def _gather_along(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    whole = _all_gather_raw(t.movedim(axis, 0).contiguous(), mesh, DATA_AXIS)
    return whole.movedim(0, axis)


class ZeroAdamW(AdamW):
    """AdamW whose moments each rank holds a ``data``-block of."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], learning_rate: float,
                 weight_decay: float, mesh: Mesh, trainable: Optional[Dict[str, bool]] = None):
        super().__init__(params, learning_rate, weight_decay, trainable=trainable)
        self.mesh = mesh
        n = mesh.size(DATA_AXIS)
        self.axes = {name: _leaf_axis(tuple(p.shape), n) for name, p in params.items()}
        for name, axis in self.axes.items():
            if axis is None:
                continue
            self.mu[name] = _narrow(self.mu[name], axis, mesh).clone()
            self.nu[name] = _narrow(self.nu[name], axis, mesh).clone()
            self.sharded[name] = (lambda t, a=axis: _gather_along(t, a, mesh),
                                  lambda t, a=axis: _narrow(t, a, mesh).clone())

    def sharded_names(self):
        return sorted(name for name, axis in self.axes.items() if axis is not None)

    @torch.no_grad()
    def step(self) -> None:
        """Gradients summed over the other mesh axes already; summed over
        ``data`` here (reduce-scatter for a sharded leaf, all-reduce else)."""
        c1, c2 = self._advance()
        for name, p in self.params.items():
            if not self.trainable[name]:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            axis = self.axes[name]
            if axis is None:
                g, target = _all_reduce_raw(g, self.mesh, DATA_AXIS), p
            else:
                g = _reduce_scatter_raw(g.movedim(axis, 0).contiguous(), self.mesh,
                                        DATA_AXIS).movedim(0, axis)
                target = _narrow(p, axis, self.mesh)
            new = target + self._delta(name, g, target, c1, c2)
            if axis is None:
                p.copy_(new)
            else:
                p.copy_(_gather_along(new, axis, self.mesh))


def opt_state_bytes_per_device(optimizer: AdamW) -> int:
    """Bytes of moments this rank holds."""
    return sum(t.numel() * t.element_size() for slot in (optimizer.mu, optimizer.nu)
               for t in slot.values())
