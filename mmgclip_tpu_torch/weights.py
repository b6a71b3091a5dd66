"""Carry the JAX package's parameter trees into the port's modules.

A JAX tree here is a nested dict of numpy arrays: what
``utils.flax_msgpack`` reads from flax bytes, or ``jax.device_get`` of a
live flax tree.  The port's modules keep the JAX layouts and names, so the
mapping is by path: the flax path ``stage_0/dwconv_kernel`` is the
``state_dict`` key ``stage_0.dwconv_kernel``.  That covers

* ConvNeXt's stacked ``[depth, ...]`` NHWC/HWIO tree (``convnext.py:121-133``
  of the JAX package), stem, downsamples and head;
* BERT's ``[L, H, 3, heads, dh]`` qkv layout and its other stacked tensors;
* the trainable CLIP tree (``image_projection``, ``text_projection``,
  ``logit_scale``).

Every key, shape and count must match: a mismatch raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a.b.c": array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, path + "."))
        else:
            out[path] = np.asarray(value)
    return out


@torch.no_grad()
def load_flax_tree(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` in place (keeps each
    parameter's device and dtype)."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(
            f"{type(module).__name__}: tree does not match the module; "
            f"missing {missing}, unexpected {unexpected}")
    for name, param in params.items():
        value = flat[name]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: tree has shape {value.shape}, module {tuple(param.shape)}")
        param.copy_(torch.tensor(value, dtype=param.dtype))
    return module


@torch.no_grad()
def load_clip_params(model: nn.Module, trainable: Dict[str, Any]) -> nn.Module:
    """The JAX ``MMGCLIP.trainable_params`` tree -> ``MMGCLIP``'s heads and
    logit scale."""
    expected = {"logit_scale"}
    for name in ("image_projection", "text_projection"):
        head = getattr(model, name)
        if head is not None:
            expected.add(name)
            load_flax_tree(head, trainable[name])
    if set(trainable) != expected:
        raise KeyError(f"trainable tree keys {sorted(trainable)} != {sorted(expected)}")
    model.logit_scale.copy_(torch.as_tensor(np.asarray(trainable["logit_scale"])))
    return model
