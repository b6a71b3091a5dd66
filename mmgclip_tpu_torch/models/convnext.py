"""ConvNeXt-Tiny image tower in PyTorch (port of mmgclip_tpu/models/convnext.py).

NHWC throughout, parameters in the JAX layout (``weights.load_flax_tree``
moves a JAX tree across by name): the stem and downsample convs are HWIO
kernels run as patchify matmuls, and each stage keeps its blocks' parameters
stacked ``[depth, ...]``.  With ``use_fused_blocks`` every residual block
runs ``ops.fused_block.fused_convnext_block`` (the CUDA kernel on the card);
otherwise the plain unfused math, which is the same function.  The stem,
downsample and their LayerNorms are plain PyTorch, as they run outside any
Pallas kernel in the JAX preset this ports.

Not ported yet (ROADMAP.md): the masked ``valid_hw`` bucketed path, int8
``quant``, the fused stem / downsample / standalone depthwise kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.fused_block import fused_convnext_block, plain_convnext_block
from ._params import ParamGroup, dense, flax_layer_norm, lecun_normal, norm


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 2  # binary normal/abnormal classifier head
    layer_scale_init: float = 1e-6
    in_channels: int = 3
    dtype: torch.dtype = torch.float32
    # run each residual block as ONE fused kernel (ops/fused_block.py)
    use_fused_blocks: bool = False
    # "exact" (torch-parity nn.GELU) or "tanh" (the tanh approximation)
    gelu: str = "exact"

    @staticmethod
    def tiny(num_classes: int = 2) -> "ConvNeXtConfig":
        return ConvNeXtConfig(num_classes=num_classes)

    @staticmethod
    def micro(num_classes: int = 2) -> "ConvNeXtConfig":
        """Small test-size variant."""
        return ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 32, 768), num_classes=num_classes)


def patchify_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """s x s / s conv of NHWC ``x`` with an HWIO ``kernel`` as one matmul,
    zero-padding the bottom/right to a multiple of s (``br_pad``: anchors the
    conv at (0, 0), like the JAX tower).  Computes in ``dtype``."""
    s = kernel.shape[0]
    n, h, w, c = x.shape
    x = nn.functional.pad(x, (0, 0, 0, (-w) % s, 0, (-h) % s))
    hp, wp = x.shape[1] // s, x.shape[2] // s
    patches = x.reshape(n, hp, s, wp, s, c).permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, s * s * c)
    return patches.to(dtype) @ kernel.reshape(s * s * c, -1).to(dtype) + bias.to(dtype)


class ConvNeXtStage(nn.Module):
    """``depth`` residual blocks with stacked parameters."""

    def __init__(self, dim: int, depth: int, layer_scale_init: float, dtype: torch.dtype,
                 use_fused_blocks: bool, gelu: str, generator: torch.Generator):
        super().__init__()
        if gelu not in ("exact", "tanh"):
            raise ValueError(f"ConvNeXtConfig.gelu must be 'exact' or 'tanh', got {gelu!r}")
        d = dim
        self.depth = depth
        self.dtype = dtype
        self.use_fused_blocks = use_fused_blocks
        self.gelu_tanh = gelu == "tanh"
        self.dwconv_kernel = nn.Parameter(lecun_normal((depth, 7, 7, 1, d), 49, generator))
        self.dwconv_bias = nn.Parameter(torch.zeros(depth, d))
        self.norm_scale = nn.Parameter(torch.ones(depth, d))
        self.norm_bias = nn.Parameter(torch.zeros(depth, d))
        self.pwconv1_kernel = nn.Parameter(lecun_normal((depth, d, 4 * d), d, generator))
        self.pwconv1_bias = nn.Parameter(torch.zeros(depth, 4 * d))
        self.pwconv2_kernel = nn.Parameter(lecun_normal((depth, 4 * d, d), 4 * d, generator))
        self.pwconv2_bias = nn.Parameter(torch.zeros(depth, d))
        self.gamma = nn.Parameter(torch.full((depth, d), float(layer_scale_init)))

    def block_args(self, i: int):
        """Block ``i``'s parameters as the block functions take them: the LN
        affine stays fp32 (as in the JAX tower), the rest in the tower dtype."""
        dt = self.dtype
        return (self.dwconv_kernel[i].to(dt), self.dwconv_bias[i].to(dt),
                self.norm_scale[i].float(), self.norm_bias[i].float(),
                self.pwconv1_kernel[i].to(dt), self.pwconv1_bias[i].to(dt),
                self.pwconv2_kernel[i].to(dt), self.pwconv2_bias[i].to(dt),
                self.gamma[i].to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        block = fused_convnext_block if self.use_fused_blocks else plain_convnext_block
        x = x.to(self.dtype)
        for i in range(self.depth):
            x = block(x, *self.block_args(i), gelu_tanh=self.gelu_tanh)
        return x


class ConvNeXt(nn.Module):
    """ConvNeXt backbone: stem -> 4 stages -> pooled features."""

    def __init__(self, config: ConvNeXtConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        cin, d0 = cfg.in_channels, cfg.dims[0]
        self.stem_conv = ParamGroup(kernel=lecun_normal((4, 4, cin, d0), 16 * cin, g),
                                    bias=torch.zeros(d0))
        self.stem_norm = norm(d0)
        for stage, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            if stage > 0:
                prev = cfg.dims[stage - 1]
                setattr(self, f"downsample_{stage}_norm", norm(prev))
                setattr(self, f"downsample_{stage}_conv",
                        ParamGroup(kernel=lecun_normal((2, 2, prev, dim), 4 * prev, g),
                                   bias=torch.zeros(dim)))
            setattr(self, f"stage_{stage}",
                    ConvNeXtStage(dim, depth, cfg.layer_scale_init, cfg.dtype,
                                  cfg.use_fused_blocks, cfg.gelu, g))
        self.head_norm = norm(cfg.dims[-1])
        self.head_fc = dense(cfg.dims[-1], cfg.num_classes, g)

    def forward(self, x: torch.Tensor, pool: bool = True, classify: bool = False) -> torch.Tensor:
        """x: [n, H, W, in_channels] NHWC -> pooled [n, dims[-1]] (or the
        head's logits with ``classify``, or the feature map without ``pool``)."""
        cfg = self.config
        x = patchify_conv(x, self.stem_conv.kernel, self.stem_conv.bias, cfg.dtype)
        x = flax_layer_norm(x, self.stem_norm.scale, self.stem_norm.bias)
        for stage in range(len(cfg.depths)):
            if stage > 0:
                ln = getattr(self, f"downsample_{stage}_norm")
                conv = getattr(self, f"downsample_{stage}_conv")
                x = flax_layer_norm(x, ln.scale, ln.bias)
                x = patchify_conv(x, conv.kernel, conv.bias, cfg.dtype)
            x = getattr(self, f"stage_{stage}")(x)
        if not pool:
            return x
        pooled = x.mean(dim=(1, 2))  # global average pool -> [n, dims[-1]]
        if not classify:
            return pooled
        h = flax_layer_norm(pooled, self.head_norm.scale, self.head_norm.bias)
        return h @ self.head_fc.kernel + self.head_fc.bias
