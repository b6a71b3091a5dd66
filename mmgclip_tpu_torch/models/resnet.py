"""ResNet-50 image encoder, the ablation tower (port of
mmgclip_tpu/models/resnet.py).

A conv stem, then bottleneck stages ``(3, 4, 6, 3)`` at width 64, global
average pooled to ``width * 32`` features (2048; 256 for ``micro()``).  A
flat stored feature ``[b, D]`` is tiled into a 3-channel pseudo-image, as
the JAX tower tiles it into NHWC ``[b, 1, D, 3]``; the port runs NCHW, so
the pseudo-image is ``[b, 3, 1, D]``.  Parameters keep the flax names and
layouts (``conv1.kernel`` HWIO, ``bn1.scale`` / ``bn1.bias``,
``layer4_block0.down_conv.kernel``...), so ``weights.load_flax_tree`` moves
a JAX tree across by name and the dotted names are the JAX tree's paths;
each conv permutes its HWIO kernel to OIHW per call.  The running
statistics (flax's ``batch_stats`` collection: ``mean`` / ``var``) are
buffers of the same paths (``weights.load_head_state``).  The convolutions
and the normalisation are ``F.conv2d`` / ``F.batch_norm``: JAX computes them
with ``lax.conv`` and XLA ops, outside any Pallas kernel.

Padding is flax's: the 7x7/2 stem pads 3, the 3x3 convs pad 1, the 1x1
convs (``down_conv`` at stride 2 too) are ``'SAME'``, which for a 1x1 kernel
is no padding, and the 3x3/2 max pool pads 1 with -inf.

DELIBERATE divergence (PARITY.md #8): BatchNorm runs in FROZEN mode
(running stats, never batch stats) even when `train=True` and layer4
fine-tunes.  The torch reference's train() mode uses batch statistics
and mutates running stats per step; mutable BN state inside a jitted
donated-buffer train step would force threading batch_stats through
every step signature for an ablation-only tower, and frozen-BN
fine-tuning is the standard practice for small-batch transfer
anyway.  Here every normalisation is ``F.batch_norm(..., training=False)``
over the buffers, whatever ``Module.train()`` says.

``remat`` (on by default, as in JAX) recomputes each bottleneck in the
backward pass (``torch.utils.checkpoint``, non-reentrant).  The tower draws
no random numbers, so the checkpoint saves no RNG state
(``preserve_rng_state=False``): reading a CUDA generator's state is refused
while a CUDA graph captures, and the trainer captures its step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ._params import ParamGroup

BN_EPS = 1e-5  # flax.linen.BatchNorm's default epsilon


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    dtype: torch.dtype = torch.float32
    # recompute bottleneck activations in the backward pass: trades
    # recompute for memory when layer4 trains
    remat: bool = True

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def micro() -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1, 1, 1), width=8)


def conv_kernel(kh: int, kw: int, cin: int, cout: int, generator: torch.Generator) -> torch.Tensor:
    """An HWIO kernel drawn as flax's default ``lecun_normal`` draws it: a
    normal truncated at two standard deviations, scaled to variance
    ``1 / fan_in``."""
    std = math.sqrt(1.0 / (kh * kw * cin)) / 0.87962566103423978  # truncation's std correction
    out = torch.empty(kh, kw, cin, cout)
    return nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std, generator=generator)


class Conv(ParamGroup):
    """``nn.Conv(features, (k, k), use_bias=False)`` with its HWIO ``kernel``."""

    def __init__(self, k: int, cin: int, cout: int, generator: torch.Generator,
                 stride: int = 1, padding: int = 0):
        super().__init__(kernel=conv_kernel(k, k, cin, cout, generator))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.conv2d(x.to(dtype), self.kernel.permute(3, 2, 0, 1).to(dtype),
                        stride=self.stride, padding=self.padding)


class FrozenBatchNorm(ParamGroup):
    """``nn.BatchNorm(use_running_average=True)``: ``scale`` / ``bias``
    parameters, ``mean`` / ``var`` buffers (the ``batch_stats`` collection)."""

    def __init__(self, width: int):
        super().__init__(scale=torch.ones(width), bias=torch.zeros(width))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=BN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, strides: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(1, cin, features, generator)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv(3, features, features, generator, stride=strides, padding=1)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = Conv(1, features, features * 4, generator)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.down_conv = self.down_bn = None
        if cin != features * 4 or strides != 1:
            self.down_conv = Conv(1, cin, features * 4, generator, stride=strides)
            self.down_bn = FrozenBatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, self.dtype)))
        y = F.relu(self.bn2(self.conv2(y, self.dtype)))
        y = self.bn3(self.conv3(y, self.dtype))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x, self.dtype))
        return F.relu(y + residual)


class ResNet50Encoder(nn.Module):
    """Conv stem + 4 bottleneck stages; returns pooled ``[b, width * 32]``
    features.  ``generator``: the seeded init's source (flax's default
    initializers: ``lecun_normal`` kernels, BN scale 1 / bias 0, running
    mean 0 / variance 1)."""

    def __init__(self, config: ResNetConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.conv1 = Conv(7, 3, config.width, gen, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm(config.width)
        self.block_names = []
        cin = config.width
        for stage, num_blocks in enumerate(config.stage_sizes):
            features = config.width * (2 ** stage)
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, Bottleneck(cin, features, strides, config.dtype, gen))
                self.block_names.append(name)
                cin = features * 4
        self.output_dimension = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[b, D]`` stored features (tiled into the ``[b, 3, 1, D]``
        pseudo-image) or an NCHW image batch."""
        if x.dim() == 2:
            x = x[:, None, None, :].expand(-1, 3, 1, -1)
        y = F.relu(self.bn1(self.conv1(x, self.config.dtype)))
        y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        remat = self.config.remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            y = (checkpoint(block, y, use_reentrant=False, preserve_rng_state=False)
                 if remat else block(y))
        return y.mean(dim=(2, 3))
