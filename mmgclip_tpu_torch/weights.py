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
  ``logit_scale``), every head included: the BatchNorm ``ProjectionHead``'s
  ``batch_stats`` go to its buffers (``load_head_state``), the MoE head's
  ``[E, ...]`` expert stacks by name.

Every key, shape and count must match: a mismatch raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
def load_head_state(module: nn.Module, collections: Dict[str, Any]) -> nn.Module:
    """A flax head's non-parameter collections (``{"batch_stats": {"bn_0":
    {"mean", "var"}, ...}}``) -> the module's buffers of the same paths."""
    flat = flatten_tree(collections.get("batch_stats", {}))
    buffers = dict(module.named_buffers())
    if set(flat) != set(buffers) or set(collections) - {"batch_stats"}:
        raise KeyError(f"{type(module).__name__}: head state {sorted(flat)} (collections "
                       f"{sorted(collections)}) does not match its buffers {sorted(buffers)}")
    for name, buffer in buffers.items():
        if tuple(flat[name].shape) != tuple(buffer.shape):
            raise ValueError(f"{name}: tree has shape {flat[name].shape}, module {tuple(buffer.shape)}")
        buffer.copy_(torch.tensor(flat[name], dtype=buffer.dtype))
    return module


@torch.no_grad()
def load_clip_params(model: nn.Module, trainable: Dict[str, Any],
                     head_state: Optional[Dict[str, Any]] = None) -> nn.Module:
    """The JAX ``MMGCLIP.trainable_params`` tree -> ``MMGCLIP``'s heads and
    logit scale, in place.  ``head_state``: the JAX model's ``_head_state``
    (``{"image_projection": {"batch_stats": ...}, ...}``)."""
    expected = {"logit_scale"}
    for name in ("image_projection", "text_projection"):
        head = getattr(model, name)
        if head is not None:
            expected.add(name)
            load_flax_tree(head, trainable[name])
            if head_state is not None:
                load_head_state(head, head_state.get(name, {}))
    if set(trainable) != expected:
        raise KeyError(f"trainable tree keys {sorted(trainable)} != {sorted(expected)}")
    model.logit_scale.copy_(torch.as_tensor(np.array(trainable["logit_scale"], np.float32)))
    return model


def module_tree(module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters -> nested dict of numpy arrays by flax path
    (the inverse of ``load_flax_tree``)."""
    tree: Dict[str, Any] = {}
    for name, param in module.named_parameters():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = param.detach().cpu().numpy().copy()
    return tree


def clip_params_tree(model: nn.Module) -> Dict[str, Any]:
    """``MMGCLIP``'s heads and logit scale -> the JAX ``trainable_params``
    tree of numpy arrays (the inverse of ``load_clip_params``; what the
    checkpoint writer stores)."""
    tree: Dict[str, Any] = {}
    for name in ("image_projection", "text_projection"):
        head = getattr(model, name)
        if head is not None:
            tree[name] = module_tree(head)
    tree["logit_scale"] = model.logit_scale.detach().cpu().numpy().copy()
    return tree
