"""Projection heads mapping tower features into the joint space
(port of mmgclip_tpu/models/projections.py).

The heads the stock ``configs/projection/`` files name: bias-free linear,
multi-linear stack with ReLU (+dropout) and the residual MLP head.  The
BatchNorm ``ProjectionHead`` and the MoE head are not ported yet.  Dropout
is the identity at inference, the only mode serving runs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..config.registry import PROJECTIONS
from ._params import dense, flax_layer_norm, norm


@PROJECTIONS.register("LinearProjectionLayer")
class LinearProjectionLayer(nn.Module):
    """Single bias-free linear map."""

    def __init__(self, embedding_dim: int, projection_dim: int = 512, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.layer = dense(embedding_dim, int(projection_dim), g, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        fan_in = embedding_dim
        for i, width in enumerate(dims):
            setattr(self, f"layers_{i}", dense(fan_in, width, g))
            fan_in = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            layer = getattr(self, f"layers_{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


@PROJECTIONS.register("MLPProjectionHead")
class MLPProjectionHead(nn.Module):
    """Linear -> GELU -> Linear -> (dropout) -> residual -> LayerNorm."""

    def __init__(self, embedding_dim: int, projection_dim: int = 512, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        p = int(projection_dim)
        self.projection = dense(embedding_dim, p, g)
        self.fc = dense(p, p, g)
        self.layer_norm = norm(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = x @ self.projection.kernel + self.projection.bias
        x = nn.functional.gelu(projected, approximate="none")
        x = x @ self.fc.kernel + self.fc.bias
        x = x + projected
        return flax_layer_norm(x, self.layer_norm.scale, self.layer_norm.bias)


def get_projection_head(name: str):
    """Name -> module class."""
    return PROJECTIONS.get(name)
