"""ConvNeXt (Liu et al. 2022, arXiv:2201.03545) over raw 16-bit pixels, plain.

Intensities: ``(p - 32767.5) / 32767.5`` for 16-bit pixels (8-bit pixels are
first scaled by 257), the reference pipeline's normalisation.  Tower: a 4x4
stride-4 patchify stem and a LayerNorm; four stages of blocks (7x7
depthwise conv, LayerNorm, pointwise 4x MLP with exact GELU, layer scale,
residual), a LayerNorm and a 2x2 stride-2 conv between stages; the feature
is the global mean of the last stage.  An edge that does not divide the
stride is zero-padded at the bottom and right, as the repository's towers
do.  LayerNorms use eps 1e-6.  Weights: the benchmark's tree (HWIO conv
kernels, ``[in, out]`` pointwise kernels, blocks stacked ``[depth, ...]``).
Runs one image at a time in float32, NCHW.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _ln_channels(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW tensor."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], scale, bias, EPS)
    return y.permute(0, 3, 1, 2)


def _patchify_conv(x: torch.Tensor, kernel_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    s = kernel_hwio.shape[0]
    x = F.pad(x, (0, (-x.shape[3]) % s, 0, (-x.shape[2]) % s))
    return F.conv2d(x, kernel_hwio.permute(3, 2, 0, 1), bias, stride=s)


class ConvNeXt:
    def __init__(self, tree: Dict, device):
        self.device = device
        self.p = {k: {kk: _t(vv, device) for kk, vv in v.items()} for k, v in tree.items()}
        self.stages = sorted(int(k.split("_")[1]) for k in self.p if k.startswith("stage_"))

    @torch.no_grad()
    def features(self, pixels: np.ndarray) -> torch.Tensor:
        """[H, W] uint8 / uint16 pixels -> the [D] float32 feature."""
        x = torch.as_tensor(pixels.astype(np.float32), device=self.device)
        if pixels.dtype == np.uint8:
            x = x * 257.0
        x = ((x - 32767.5) / 32767.5)[None, None]
        cin = self.p["stem_conv"]["kernel"].shape[2]
        x = x.expand(1, cin, *x.shape[2:])
        p = self.p
        x = _patchify_conv(x, p["stem_conv"]["kernel"], p["stem_conv"]["bias"])
        x = _ln_channels(x, p["stem_norm"]["scale"], p["stem_norm"]["bias"])
        for s in self.stages:
            if s > 0:
                x = _ln_channels(x, p[f"downsample_{s}_norm"]["scale"], p[f"downsample_{s}_norm"]["bias"])
                x = _patchify_conv(x, p[f"downsample_{s}_conv"]["kernel"], p[f"downsample_{s}_conv"]["bias"])
            st = p[f"stage_{s}"]
            for i in range(st["gamma"].shape[0]):
                c = x.shape[1]
                y = F.conv2d(x, st["dwconv_kernel"][i].permute(3, 2, 0, 1), st["dwconv_bias"][i],
                             padding=3, groups=c)
                y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), st["norm_scale"][i], st["norm_bias"][i], EPS)
                y = F.gelu(y @ st["pwconv1_kernel"][i] + st["pwconv1_bias"][i])
                y = y @ st["pwconv2_kernel"][i] + st["pwconv2_bias"][i]
                x = x + (st["gamma"][i] * y).permute(0, 3, 1, 2)
                del y
        return x.mean(dim=(0, 2, 3))
