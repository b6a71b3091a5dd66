"""ResNet-50 (He et al. 2016, arXiv:1512.03385) over a stored feature, plain.

The [b, D] feature is tiled into a 3-channel [b, 3, 1, D] pseudo-image (the
reference's ablation).  A 7x7 stride-2 conv (pad 3), BatchNorm, ReLU and a
3x3 stride-2 max pool (pad 1); bottlenecks (1x1, 3x3 with the stage's
stride, 1x1 at 4x width; a 1x1 strided projection where the shape changes)
in stages (3, 4, 6, 3) from width 64; global mean.  BatchNorm is frozen: it
normalises with the running statistics, which stay at their initial mean 0
and variance 1 (eps 1e-5), whatever the mode.  Weights: the benchmark's
tree, HWIO kernels; ``trainable`` marks the leaves that take gradients
(``layer4``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class ResNet50:
    def __init__(self, tree: Dict, device, stage_sizes=(3, 4, 6, 3)):
        self.stage_sizes = tuple(stage_sizes)
        self.p = {k: torch.as_tensor(np.asarray(v, np.float32), device=device).clone()
                  for k, v in flatten(tree).items()}
        for name, t in self.p.items():
            t.requires_grad_(name.startswith("layer4"))

    def trainable(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.p.items() if v.requires_grad}

    def _conv(self, x, name, stride=1, padding=0):
        return F.conv2d(x, self.p[name].permute(3, 2, 0, 1), stride=stride, padding=padding)

    def _bn(self, x, name):
        scale = self.p[name + ".scale"] / (1.0 + BN_EPS) ** 0.5  # running mean 0, variance 1
        return x * scale[None, :, None, None] + self.p[name + ".bias"][None, :, None, None]

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats[:, None, None, :].expand(-1, 3, 1, -1)
        x = F.relu(self._bn(self._conv(x, "conv1.kernel", 2, 3), "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                p = f"layer{stage + 1}_block{b}."
                stride = 2 if stage > 0 and b == 0 else 1
                y = F.relu(self._bn(self._conv(x, p + "conv1.kernel"), p + "bn1"))
                y = F.relu(self._bn(self._conv(y, p + "conv2.kernel", stride, 1), p + "bn2"))
                y = self._bn(self._conv(y, p + "conv3.kernel"), p + "bn3")
                if p + "down_conv.kernel" in self.p:
                    x = self._bn(self._conv(x, p + "down_conv.kernel", stride), p + "down_bn")
                x = F.relu(y + x)
        return x.mean(dim=(2, 3))
