"""Parameter groups named like the JAX package's flax trees, and shared math.

Every port module keeps its parameters in the JAX layout (NHWC/HWIO convs,
``[in, out]`` dense kernels, stacked ``[depth, ...]`` block tensors) under
names whose dotted ``state_dict`` keys equal the flax tree's paths
(``stem_conv.kernel``, ``stage_0.dwconv_kernel``, ``layer.kernel``), so
``weights.load_flax_tree`` moves a JAX tree across by name alone.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


class ParamGroup(nn.Module):
    """A flax submodule's parameters (``kernel``/``bias``, ``scale``/``bias``...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value))


def host_array(value) -> np.ndarray:
    """A tensor on any device (or an array) -> numpy, for weight importers."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def lecun_normal(shape: Sequence[int], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Normal init with std sqrt(1 / fan_in), flax's lecun_normal scale (flax
    truncates at two std; the port's seeded init is only required to be a
    plausible, reproducible initialization)."""
    return torch.randn(*shape, generator=generator) * math.sqrt(1.0 / fan_in)


def dense(fan_in: int, fan_out: int, generator: torch.Generator, bias: bool = True) -> ParamGroup:
    tensors = {"kernel": lecun_normal((fan_in, fan_out), fan_in, generator)}
    if bias:
        tensors["bias"] = torch.zeros(fan_out)
    return ParamGroup(**tensors)


def norm(width: int) -> ParamGroup:
    return ParamGroup(scale=torch.ones(width), bias=torch.zeros(width))


def flax_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """``flax.linen.LayerNorm`` with fp32 params: statistics in fp32 with
    flax's fast variance (E[x^2] - E[x]^2, clipped at 0), fp32 result."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * scale) + bias


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX towers' own ``_layer_norm``: two-pass variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def weight(p: torch.Tensor, dtype: torch.dtype, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round ``p`` to ``dtype`` and promote against ``like``, as
    ``x @ p.astype(dtype)`` promotes in JAX."""
    p = p.to(dtype)
    if like is not None:
        p = p.to(torch.promote_types(dtype, like.dtype))
    return p
