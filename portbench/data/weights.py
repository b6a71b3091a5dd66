"""Seeded weights, made on the device in one draw per tree.

Each tree is a nested dict in the port's (the JAX package's) parameter
layout, so the port loads it by name through its own loaders.  Every leaf
is a slice of one ``torch.randn`` call on a generator on the device, scaled
to a trained-looking magnitude: kernels at ``1 / sqrt(fan_in)``, norm scales
near 1, biases near 0, ConvNeXt's layer scale near ``layer_scale`` (0.1, a
trained magnitude, not the 1e-6 of a fresh init, so that the comparison
sees the blocks' arithmetic).  ``make(bf16=True)`` rounds the values to
bfloat16 on the device; the same values go to the port (as files or in
memory) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .flax_bytes import Bf16

_MIX = 0x9E3779B97F4A7C15
TAGS = {"convnext": 1, "bert": 2, "resnet": 3, "heads": 4}


def tree_seed(seed: int, tag: str) -> int:
    """A generator seed for tree ``tag`` of run seed ``seed`` (under 2**63)."""
    return (int(seed) * _MIX + TAGS[tag]) % (1 << 63)


class TreeMaker:
    """Collects leaves ``(path, shape, mean, std)``; ``make`` draws them."""

    def __init__(self):
        self.leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], float, float]] = []

    def add(self, path: str, shape: Sequence[int], std: float, mean: float = 0.0) -> None:
        self.leaves.append((tuple(path.split(".")), tuple(int(s) for s in shape), mean, std))

    def kernel(self, path: str, shape: Sequence[int], fan_in: int) -> None:
        self.add(path, shape, math.sqrt(1.0 / fan_in))

    def norm(self, path: str, width, scale_mean: float = 1.0, scale_std: float = 0.1) -> None:
        shape = (width,) if isinstance(width, int) else width
        self.add(path + ".scale", shape, scale_std, scale_mean)
        self.add(path + ".bias", shape, 0.02)

    def make(self, seed: int, device, bf16: bool = False):
        """-> (values: nested dict of float32 numpy arrays, file: the same
        tree as the file holds it: float32 arrays, or ``Bf16`` bits)."""
        sizes = [int(np.prod(shape)) for _p, shape, _m, _s in self.leaves]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        offsets = np.cumsum([0] + sizes)
        scale = torch.tensor([s for *_r, s in self.leaves], device=device).repeat_interleave(
            torch.tensor(sizes, device=device))
        shift = torch.tensor([m for *_r, m, _s in self.leaves], device=device).repeat_interleave(
            torch.tensor(sizes, device=device))
        flat = flat * scale + shift
        if bf16:
            rounded = flat.to(torch.bfloat16)
            bits = rounded.view(torch.int16).cpu().numpy().view(np.uint16)
            flat = rounded.float()
        host = flat.cpu().numpy()
        values: Dict = {}
        file: Dict = {}
        for (path, shape, _m, _s), lo, hi in zip(self.leaves, offsets[:-1], offsets[1:]):
            value = host[lo:hi].reshape(shape)
            stored = Bf16(bits[lo:hi].reshape(shape)) if bf16 else value
            for tree, leaf in ((values, value), (file, stored)):
                node = tree
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = leaf
        return values, file


def convnext_tree(depths: Sequence[int], dims: Sequence[int], in_channels: int,
                  num_classes: int, layer_scale: float) -> TreeMaker:
    t = TreeMaker()
    t.kernel("stem_conv.kernel", (4, 4, in_channels, dims[0]), 16 * in_channels)
    t.add("stem_conv.bias", (dims[0],), 0.02)
    t.norm("stem_norm", dims[0])
    for s, (depth, d) in enumerate(zip(depths, dims)):
        if s > 0:
            prev = dims[s - 1]
            t.norm(f"downsample_{s}_norm", prev)
            t.kernel(f"downsample_{s}_conv.kernel", (2, 2, prev, d), 4 * prev)
            t.add(f"downsample_{s}_conv.bias", (d,), 0.02)
        p = f"stage_{s}."
        t.kernel(p + "dwconv_kernel", (depth, 7, 7, 1, d), 49)
        t.add(p + "dwconv_bias", (depth, d), 0.02)
        t.add(p + "norm_scale", (depth, d), 0.1, 1.0)
        t.add(p + "norm_bias", (depth, d), 0.02)
        t.kernel(p + "pwconv1_kernel", (depth, d, 4 * d), d)
        t.add(p + "pwconv1_bias", (depth, 4 * d), 0.02)
        t.kernel(p + "pwconv2_kernel", (depth, 4 * d, d), 4 * d)
        t.add(p + "pwconv2_bias", (depth, d), 0.02)
        t.add(p + "gamma", (depth, d), 0.1 * layer_scale, layer_scale)
    t.norm("head_norm", dims[-1])
    t.kernel("head_fc.kernel", (dims[-1], num_classes), dims[-1])
    t.add("head_fc.bias", (num_classes,), 0.02)
    return t


def bert_tree(vocab_size: int, hidden_size: int, num_hidden_layers: int,
              num_attention_heads: int, intermediate_size: int,
              max_position_embeddings: int, type_vocab_size: int) -> TreeMaker:
    t = TreeMaker()
    h, n_layers, inner = hidden_size, num_hidden_layers, intermediate_size
    dh = h // num_attention_heads
    for name, rows in (("word_embeddings", vocab_size),
                       ("position_embeddings", max_position_embeddings),
                       ("token_type_embeddings", type_vocab_size)):
        t.kernel(f"{name}.embedding", (rows, h), h)
    t.norm("embeddings_norm", h)
    t.kernel("qkv_kernel", (n_layers, h, 3, num_attention_heads, dh), h)
    t.add("qkv_bias", (n_layers, 3, num_attention_heads, dh), 0.02)
    t.kernel("out_kernel", (n_layers, h, h), h)
    t.add("out_bias", (n_layers, h), 0.02)
    t.add("attn_norm_scale", (n_layers, h), 0.1, 1.0)
    t.add("attn_norm_bias", (n_layers, h), 0.02)
    t.kernel("mlp_in_kernel", (n_layers, h, inner), h)
    t.add("mlp_in_bias", (n_layers, inner), 0.02)
    t.kernel("mlp_out_kernel", (n_layers, inner, h), inner)
    t.add("mlp_out_bias", (n_layers, h), 0.02)
    t.add("out_norm_scale", (n_layers, h), 0.1, 1.0)
    t.add("out_norm_bias", (n_layers, h), 0.02)
    return t


def resnet_tree(stage_sizes: Sequence[int], width: int, t: TreeMaker = None,
                prefix: str = "") -> TreeMaker:
    """The ResNet-50 tower's parameters (its running statistics stay at the
    tower's own init: mean 0, variance 1).  The last norm of each bottleneck
    starts small (0.25), as a trained residual branch is, so the features
    stay in range over 16 blocks."""
    t = t or TreeMaker()
    t.kernel(prefix + "conv1.kernel", (7, 7, 3, width), 49 * 3)
    t.norm(prefix + "bn1", width)
    cin = width
    for stage, blocks in enumerate(stage_sizes):
        f = width * 2 ** stage
        for b in range(blocks):
            p = f"{prefix}layer{stage + 1}_block{b}."
            t.kernel(p + "conv1.kernel", (1, 1, cin, f), cin)
            t.norm(p + "bn1", f)
            t.kernel(p + "conv2.kernel", (3, 3, f, f), 9 * f)
            t.norm(p + "bn2", f)
            t.kernel(p + "conv3.kernel", (1, 1, f, 4 * f), f)
            t.norm(p + "bn3", 4 * f, scale_mean=0.25, scale_std=0.05)
            if cin != 4 * f or (stage > 0 and b == 0):
                t.kernel(p + "down_conv.kernel", (1, 1, cin, 4 * f), cin)
                t.norm(p + "down_bn", 4 * f)
            cin = 4 * f
    return t


def heads_tree(image_dim: int, text_dim: int, projection_dim: int,
               t: TreeMaker = None) -> TreeMaker:
    """The linear CLIP heads (``1xLinear512``); ``logit_scale`` is added by
    the caller (a constant of the configuration)."""
    t = t or TreeMaker()
    t.kernel("image_projection.layer.kernel", (image_dim, projection_dim), image_dim)
    t.kernel("text_projection.layer.kernel", (text_dim, projection_dim), text_dim)
    return t
