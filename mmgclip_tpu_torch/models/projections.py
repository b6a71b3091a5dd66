"""Projection heads mapping tower features into the joint space
(port of mmgclip_tpu/models/projections.py).

Bias-free linear, multi-linear stack with ReLU (+dropout), the BatchNorm
MLP (``ProjectionHead``), the residual MLP head and the Switch-routed
mixture-of-experts head (``MoEProjectionHead``).  Dropout is the identity
at inference; in training (``train=True``) it draws flax's masks from the
head's dropout key (a threefry key tensor, ``utils/prng.py``): each Dropout
site folds in the constant flax's ``make_rng`` folds in at that site
(``Dropout_<i>`` of the head applied on its own), computed once here.  A
head's ``EXTRA_KNOBS`` are the ``projection.config`` keys the CLIP model
passes on to it (the MoE head's ``n_experts``...).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..config.registry import PROJECTIONS
from ..ops import dropout as dropout_op
from ..utils.prng import make_rng_constant
from ._params import ParamGroup, dense, flax_layer_norm, lecun_normal, norm

BN_EPSILON = 1e-5  # flax nn.BatchNorm's default


def dropout_folds(n: int):
    """The fold constants of a head's ``Dropout_0 .. Dropout_{n-1}``."""
    return [make_rng_constant([f"Dropout_{i}"]) for i in range(n)]


def dropout(x: torch.Tensor, rate: float, train: bool, key: Optional[torch.Tensor] = None,
            fold: int = 0) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability ``1 - rate``
    (``bernoulli`` under ``fold_in(key, fold)``) and scale kept values by
    ``1 / (1 - rate)``; the identity unless training."""
    if not train or rate == 0.0:
        return x
    if key is None:
        raise ValueError("train-mode dropout needs the head's dropout key")
    return dropout_op.dropout(x, key, fold, rate)


@PROJECTIONS.register("LinearProjectionLayer")
class LinearProjectionLayer(nn.Module):
    """Single bias-free linear map."""

    def __init__(self, embedding_dim: int, projection_dim: int = 512, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.layer = dense(embedding_dim, int(projection_dim), g, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x @ self.layer.kernel


@PROJECTIONS.register("MultiLinearHead")
class MultiLinearHead(nn.Module):
    """Linear stack with ReLU (+dropout) between layers; ``projection_dim`` is
    the list of layer output widths, e.g. [768, 512]."""

    def __init__(self, embedding_dim: int, projection_dim: Union[Sequence[int], int] = (768, 512),
                 dropout: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        dims = [int(projection_dim)] if isinstance(projection_dim, int) else [int(d) for d in projection_dim]
        self.n_layers = len(dims)
        self.dropout = float(dropout)
        self._folds = dropout_folds(self.n_layers - 1)
        fan_in = embedding_dim
        for i, width in enumerate(dims):
            setattr(self, f"layers_{i}", dense(fan_in, width, g))
            fan_in = width

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            layer = getattr(self, f"layers_{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n_layers - 1:
                x = dropout(torch.relu(x), self.dropout, train, key, self._folds[i])
        return x


def batch_norm(width: int) -> ParamGroup:
    """flax ``nn.BatchNorm``'s ``scale``/``bias`` parameters and its
    ``batch_stats`` (``mean``/``var``) as buffers."""
    group = norm(width)
    group.register_buffer("mean", torch.zeros(width))
    group.register_buffer("var", torch.ones(width))
    return group


def flax_batch_norm(x: torch.Tensor, bn: ParamGroup, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over the batch axis: batch statistics in train
    mode (the fast variance E[x^2] - E[x]^2, clipped at 0), the stored
    statistics otherwise.  The running statistics are never updated: the JAX
    CLIP model discards the update (``mmgclip_tpu/models/clip.py:180-260``),
    so stats stay at init."""
    if train:
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
    else:
        mean, var = bn.mean, bn.var
    mul = torch.rsqrt(var + BN_EPSILON) * bn.scale
    return (x - mean) * mul + bn.bias


@PROJECTIONS.register("ProjectionHead")
class ProjectionHead(nn.Module):
    """Dense -> BatchNorm -> ReLU (-> dropout) per hidden width, then a dense
    output layer (reference: projection.py:64-83; unused by stock configs)."""

    EXTRA_KNOBS = ("hidden_dims", "use_batchnorm")

    def __init__(self, embedding_dim: int, projection_dim: int = 64, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 hidden_dims: Sequence[int] = (512, 256, 128), use_batchnorm: bool = True):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.hidden_dims = [int(d) for d in hidden_dims]
        self.use_batchnorm = bool(use_batchnorm)
        self.dropout = float(dropout)
        self._folds = dropout_folds(len(self.hidden_dims))  # a Dropout per hidden layer when > 0
        fan_in = embedding_dim
        for i, width in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", dense(fan_in, width, g))
            if self.use_batchnorm:
                setattr(self, f"bn_{i}", batch_norm(width))
            fan_in = width
        self.out = dense(fan_in, int(projection_dim), g)

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(len(self.hidden_dims)):
            layer = getattr(self, f"hidden_{i}")
            x = x @ layer.kernel + layer.bias
            if self.use_batchnorm:
                x = flax_batch_norm(x, getattr(self, f"bn_{i}"), train)
            x = dropout(torch.relu(x), self.dropout, train, key, self._folds[i])
        return x @ self.out.kernel + self.out.bias


@PROJECTIONS.register("MLPProjectionHead")
class MLPProjectionHead(nn.Module):
    """Linear -> GELU -> Linear -> (dropout) -> residual -> LayerNorm."""

    def __init__(self, embedding_dim: int, projection_dim: int = 512, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        p = int(projection_dim)
        self.dropout = float(dropout)
        self._folds = dropout_folds(1)
        self.projection = dense(embedding_dim, p, g)
        self.fc = dense(p, p, g)
        self.layer_norm = norm(p)

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        projected = x @ self.projection.kernel + self.projection.bias
        x = nn.functional.gelu(projected, approximate="none")
        x = x @ self.fc.kernel + self.fc.bias
        x = dropout(x, self.dropout, train, key, self._folds[0])
        x = x + projected
        return flax_layer_norm(x, self.layer_norm.scale, self.layer_norm.bias)


@PROJECTIONS.register("MoEProjectionHead")
class MoEProjectionHead(nn.Module):
    """Switch-style top-1 mixture of experts (the JAX package's extension;
    ``mmgclip_tpu/models/projections.py:97-128``).

    The router picks one expert per row; each expert takes at most
    ``max(1, int(capacity_factor * n / n_experts))`` rows of a batch of n, in
    row order, and rows past that capacity are dropped (zero output).  The
    gate probability scales the expert's output so the router gets gradient.
    Expert weights carry a leading ``[E, ...]`` axis.  The JAX head's
    advisory load-balancing loss (sown, added to no objective) is not
    computed."""

    EXTRA_KNOBS = ("n_experts", "capacity_factor")

    def __init__(self, embedding_dim: int, projection_dim: int = 512, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, n_experts: int = 8,
                 capacity_factor: float = 2.0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        h, e, p = embedding_dim, int(n_experts), int(projection_dim)
        self.n_experts, self.capacity_factor, self.dropout = e, float(capacity_factor), float(dropout)
        self._folds = dropout_folds(1)
        self.router = nn.Parameter(lecun_normal((h, e), h, g))
        self.w_in = nn.Parameter(lecun_normal((e, h, p), h, g))
        self.b_in = nn.Parameter(torch.zeros(e, p))
        self.w_out = nn.Parameter(lecun_normal((e, p, p), p, g))
        self.b_out = nn.Parameter(torch.zeros(e, p))

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, e = x.shape[0], self.n_experts
        capacity = max(1, int(self.capacity_factor * n / e))
        probs = torch.softmax((x @ self.router).float(), dim=-1)
        onehot = nn.functional.one_hot(torch.argmax(probs, dim=-1), e)  # [n, e]
        # each row's place in its expert's queue: earlier rows of that expert
        position = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
        slots = torch.arange(capacity, device=x.device)
        # a position past the capacity matches no slot: the row is dropped
        dispatch = (onehot.to(x.dtype)[:, :, None]
                    * (position[:, None] == slots[None, :]).to(x.dtype)[:, None, :])  # [n, e, c]
        gate = (probs.to(x.dtype) * onehot.to(x.dtype)).sum(dim=-1)
        combine = dispatch * gate[:, None, None]
        expert_in = torch.einsum("nec,nh->ech", dispatch, x)
        hidden = nn.functional.gelu(torch.einsum("ech,ehp->ecp", expert_in, self.w_in)
                                    + self.b_in[:, None, :], approximate="none")
        expert_out = torch.einsum("ecp,epq->ecq", hidden, self.w_out) + self.b_out[:, None, :]
        y = torch.einsum("nec,ecq->nq", combine, expert_out)
        return dropout(y, self.dropout, train, key, self._folds[0])


def get_projection_head(name: str):
    """Name -> module class."""
    return PROJECTIONS.get(name)
