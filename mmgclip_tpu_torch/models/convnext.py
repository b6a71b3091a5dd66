"""ConvNeXt-Tiny image tower in PyTorch (port of mmgclip_tpu/models/convnext.py).

NHWC throughout, parameters in the JAX layout (``weights.load_flax_tree``
moves a JAX tree across by name): the stem and downsample convs are HWIO
kernels run as patchify matmuls, and each stage keeps its blocks' parameters
stacked ``[depth, ...]``.  The knobs and their gates are the JAX tower's:

* ``use_fused_blocks``: every residual block runs
  ``ops.fused_block.fused_convnext_block`` (``fused_convnext_block_int8``
  with ``quant="int8"``), the CUDA kernel on the card;
* ``fuse_stem`` / ``fuse_downsample`` (only with ``use_fused_blocks``): the
  stem and the inter-stage LN + 2x2 conv run ``ops.fused_stem`` /
  ``ops.fused_downsample``; the fused downsample only when ``valid_hw`` is
  None (the per-image mask between its LN and conv is not in the kernel);
* unfused: the plain block math, with ``int8_dot`` pointwise products under
  ``quant="int8"`` and ``ops.depthwise_conv`` under ``use_pallas_dwconv``.

``valid_hw`` ([n, 2] valid pixel (H, W) per image) runs the masked tower:
images zero-padded onto a shared canvas give the features of an exact-shape
run, because the pad region is re-zeroed at every spatial-mixing boundary
(after the stem, between each downsample's LN and conv, after each block)
and the pool averages only the valid cells of the ceil chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.depthwise_conv import depthwise_conv7x7
from ..ops.fused_block import EPS, fused_convnext_block, fused_convnext_block_int8, plain_convnext_block
from ..ops.fused_downsample import fused_ln_downsample
from ..ops.fused_stem import fused_stem, patchify
from ..ops.quant import int8_dot
from ._params import ParamGroup, dense, flax_layer_norm, host_array, lecun_normal, norm


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 2  # binary normal/abnormal classifier head
    layer_scale_init: float = 1e-6
    in_channels: int = 3
    dtype: torch.dtype = torch.float32
    # route the unfused block's 7x7 depthwise conv through ops/depthwise_conv.py
    use_pallas_dwconv: bool = False
    # run each residual block as ONE fused kernel (ops/fused_block.py)
    use_fused_blocks: bool = False
    # "int8": the pointwise convs run as dynamically quantised int8 products
    # with int32 accumulation (ops/quant.py; in-kernel with use_fused_blocks)
    quant: Optional[str] = None
    # "exact" (torch-parity nn.GELU) or "tanh" (the tanh approximation)
    gelu: str = "exact"
    # stem conv + LN as one kernel (ops/fused_stem.py); needs use_fused_blocks
    fuse_stem: bool = False
    # downsample LN + 2x2 conv as one kernel (ops/fused_downsample.py); needs
    # use_fused_blocks, and applies only to unmasked (exact-shape) runs
    fuse_downsample: bool = False

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
    patches = patchify(x, s)
    return patches.to(dtype) @ kernel.reshape(patches.shape[-1], -1).to(dtype) + bias.to(dtype)


def valid_mask(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """[n, H, W, 1] {0, 1} mask (x's dtype) of rows/cols below each image's
    valid (h, w)."""
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    cols = torch.arange(x.shape[2], device=x.device)[None, None, :]
    mask = (rows < valid_hw[:, 0, None, None]) & (cols < valid_hw[:, 1, None, None])
    return mask[..., None].to(x.dtype)


def ceil_div(valid_hw: torch.Tensor, s: int) -> torch.Tensor:
    return -(-valid_hw // s)


def unfused_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False, quant=None,
                  pallas_dwconv=False):
    """The unfused block (the JAX ``ConvNeXtStage.block`` without fusion), in
    x's dtype.  ``quant="int8"`` runs both pointwise products through
    ``int8_dot`` (w1 / w2 then carry the fp32 parameters, as in JAX);
    ``pallas_dwconv`` runs the depthwise conv through its kernel."""
    if quant is None and not pallas_dwconv:
        return plain_convnext_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=gelu_tanh)
    dt = x.dtype
    if pallas_dwconv:
        y = depthwise_conv7x7(x, dwk, dwb)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), dwk.permute(3, 2, 0, 1), padding=3,
                     groups=x.shape[-1]).permute(0, 2, 3, 1) + dwb
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf - mean).square().mean(dim=-1, keepdim=True)
    y = ((yf - mean) * torch.rsqrt(var + EPS) * ns + nb).to(dt)
    approximate = "tanh" if gelu_tanh else "none"
    if quant == "int8":
        y = F.gelu(int8_dot(y, w1, out_dtype=dt) + b1, approximate=approximate)
        y = int8_dot(y, w2, out_dtype=dt) + b2
    else:
        y = F.gelu(y @ w1 + b1, approximate=approximate) @ w2 + b2
    return x + g * y


class ConvNeXtStage(nn.Module):
    """``depth`` residual blocks with stacked parameters."""

    def __init__(self, dim: int, depth: int, config: ConvNeXtConfig, generator: torch.Generator):
        super().__init__()
        if config.gelu not in ("exact", "tanh"):
            raise ValueError(f"ConvNeXtConfig.gelu must be 'exact' or 'tanh', got {config.gelu!r}")
        if config.quant not in (None, "int8"):
            raise ValueError(f"ConvNeXtConfig.quant must be None or 'int8', got {config.quant!r}")
        d = dim
        self.depth = depth
        self.config = config
        self.dwconv_kernel = nn.Parameter(lecun_normal((depth, 7, 7, 1, d), 49, generator))
        self.dwconv_bias = nn.Parameter(torch.zeros(depth, d))
        self.norm_scale = nn.Parameter(torch.ones(depth, d))
        self.norm_bias = nn.Parameter(torch.zeros(depth, d))
        self.pwconv1_kernel = nn.Parameter(lecun_normal((depth, d, 4 * d), d, generator))
        self.pwconv1_bias = nn.Parameter(torch.zeros(depth, 4 * d))
        self.pwconv2_kernel = nn.Parameter(lecun_normal((depth, 4 * d, d), 4 * d, generator))
        self.pwconv2_bias = nn.Parameter(torch.zeros(depth, d))
        self.gamma = nn.Parameter(torch.full((depth, d), float(config.layer_scale_init)))

    @property
    def dtype(self) -> torch.dtype:
        return self.config.dtype

    def block_args(self, i: int):
        """Block ``i``'s parameters as the block functions take them: the LN
        affine stays fp32 (as in the JAX tower), the rest in the tower dtype."""
        dt = self.dtype
        return (self.dwconv_kernel[i].to(dt), self.dwconv_bias[i].to(dt),
                self.norm_scale[i].float(), self.norm_bias[i].float(),
                self.pwconv1_kernel[i].to(dt), self.pwconv1_bias[i].to(dt),
                self.pwconv2_kernel[i].to(dt), self.pwconv2_bias[i].to(dt),
                self.gamma[i].to(dt))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        tanh = cfg.gelu == "tanh"
        x = x.to(self.dtype)
        for i in range(self.depth):
            args = self.block_args(i)
            if cfg.use_fused_blocks:
                block = fused_convnext_block_int8 if cfg.quant == "int8" else fused_convnext_block
                x = block(x, *args, gelu_tanh=tanh)
            else:
                if cfg.quant == "int8":  # int8_dot quantises the fp32 parameters
                    args = (*args[:4], self.pwconv1_kernel[i], args[5],
                            self.pwconv2_kernel[i], *args[7:])
                x = unfused_block(x, *args, gelu_tanh=tanh, quant=cfg.quant,
                                  pallas_dwconv=cfg.use_pallas_dwconv)
            if mask is not None:
                # re-zero the pad so the next depthwise conv sees the zeros
                # SAME padding gives an exact-shape run
                x = x * mask
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
            setattr(self, f"stage_{stage}", ConvNeXtStage(dim, depth, cfg, g))
        self.head_norm = norm(cfg.dims[-1])
        self.head_fc = dense(cfg.dims[-1], cfg.num_classes, g)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        cfg, conv, ln = self.config, self.stem_conv, self.stem_norm
        if cfg.use_fused_blocks and cfg.fuse_stem:
            return fused_stem(x, conv.kernel.to(cfg.dtype), conv.bias.to(cfg.dtype),
                              ln.scale.float(), ln.bias.float())
        return flax_layer_norm(patchify_conv(x, conv.kernel, conv.bias, cfg.dtype), ln.scale, ln.bias)

    def _downsample(self, stage: int, x: torch.Tensor, valid_hw) -> torch.Tensor:
        cfg = self.config
        ln = getattr(self, f"downsample_{stage}_norm")
        conv = getattr(self, f"downsample_{stage}_conv")
        if cfg.use_fused_blocks and cfg.fuse_downsample and valid_hw is None:
            return fused_ln_downsample(x, ln.scale.float(), ln.bias.float(),
                                       conv.kernel.to(cfg.dtype), conv.bias.to(cfg.dtype))
        x = flax_layer_norm(x, ln.scale, ln.bias)
        if valid_hw is not None:
            # LN(0) is not 0: re-zero so the strided conv's edge window
            # matches the exact-shape run
            x = x * valid_mask(x, valid_hw)
        return patchify_conv(x, conv.kernel, conv.bias, cfg.dtype)

    def forward(self, x: torch.Tensor, pool: bool = True, classify: bool = False,
                valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [n, H, W, in_channels] NHWC -> pooled [n, dims[-1]] (or the
        head's logits with ``classify``, or the feature map without ``pool``).
        ``valid_hw`` ([n, 2] integer, pixel space) runs the masked tower."""
        cfg = self.config
        x = self._stem(x)
        if valid_hw is not None:
            valid_hw = ceil_div(valid_hw, 4)  # the stride-4 stem, br-padded
            x = x * valid_mask(x, valid_hw)
        for stage in range(len(cfg.depths)):
            if stage > 0:
                x = self._downsample(stage, x, valid_hw)
                if valid_hw is not None:
                    valid_hw = ceil_div(valid_hw, 2)
                    x = x * valid_mask(x, valid_hw)
            stage_mod = getattr(self, f"stage_{stage}")
            mask = None if valid_hw is None else valid_mask(x, valid_hw).to(stage_mod.dtype)
            x = stage_mod(x, mask)
        if not pool:
            return x
        # global average pool -> [n, dims[-1]], one reduction per image: a
        # batched reduction on the card splits each output's sum over as many
        # blocks as the batch leaves room for, so an image's vector would
        # follow the other images of its batch (and the device or rank that
        # encoded it)
        if valid_hw is None:
            pooled = torch.stack([img.mean(dim=(0, 1)) for img in x])
        else:
            # the sum and the count in fp32: a bf16 count is not exact
            counts = (valid_hw[:, 0] * valid_hw[:, 1]).float()
            sums = torch.stack([img.float().sum(dim=(0, 1)) for img in x])
            pooled = (sums / torch.clamp(counts, min=1.0)[:, None]).to(x.dtype)
        if not classify:
            return pooled
        h = flax_layer_norm(pooled, self.head_norm.scale, self.head_norm.bias)
        return h @ self.head_fc.kernel + self.head_fc.bias


def torchvision_tree(state_dict, config: ConvNeXtConfig) -> dict:
    """A torchvision ``convnext_tiny`` state dict -> the JAX tower's numpy
    tree ``{"params": {...}}`` (the JAX package's ``load_torchvision_weights``
    without the flax init it overwrites).

    Conv kernels go OIHW -> HWIO, linear kernels are transposed, and each
    stage's block tensors stack along a leading ``[depth]`` axis.  The head
    (``head_norm``, ``head_fc``) is in the tree only when the state dict
    has ``classifier.*`` (the reference's TorchScript classifier does).
    torchvision keeps ``layer_scale`` as ``[C, 1, 1]``; it becomes the
    ``[C]`` gamma the block multiplies with (a ``[C]`` layer scale is
    unchanged).  ``config`` gives the depths; ``in_channels`` is the stem's.
    """
    sd = {k: host_array(v) for k, v in state_dict.items()}

    def conv(name):  # OIHW -> HWIO
        return sd[name].transpose(2, 3, 1, 0)

    def lin(name):
        return sd[name].T

    def ln(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    p = {
        "stem_conv": {"kernel": conv("features.0.0.weight"), "bias": sd["features.0.0.bias"]},
        "stem_norm": ln("features.0.1"),
    }
    # torchvision indexes: stages at features[1, 3, 5, 7], downsamples at [2, 4, 6]
    for stage, depth in enumerate(config.depths):
        if stage > 0:
            di = 2 * stage
            p[f"downsample_{stage}_norm"] = ln(f"features.{di}.0")
            p[f"downsample_{stage}_conv"] = {"kernel": conv(f"features.{di}.1.weight"),
                                             "bias": sd[f"features.{di}.1.bias"]}
        si = 2 * stage + 1
        blocks = [f"features.{si}.{b}" for b in range(depth)]
        leaves = {
            "dwconv_kernel": lambda pre: conv(f"{pre}.block.0.weight"),  # [7, 7, 1, C]
            "dwconv_bias": lambda pre: sd[f"{pre}.block.0.bias"],
            "norm_scale": lambda pre: sd[f"{pre}.block.2.weight"],
            "norm_bias": lambda pre: sd[f"{pre}.block.2.bias"],
            "pwconv1_kernel": lambda pre: lin(f"{pre}.block.3.weight"),
            "pwconv1_bias": lambda pre: sd[f"{pre}.block.3.bias"],
            "pwconv2_kernel": lambda pre: lin(f"{pre}.block.5.weight"),
            "pwconv2_bias": lambda pre: sd[f"{pre}.block.5.bias"],
            "gamma": lambda pre: sd[f"{pre}.layer_scale"].reshape(-1),
        }
        p[f"stage_{stage}"] = {key: np.stack([leaf(pre) for pre in blocks])
                               for key, leaf in leaves.items()}
    if "classifier.0.weight" in sd:
        p["head_norm"] = ln("classifier.0")
        p["head_fc"] = {"kernel": lin("classifier.2.weight"), "bias": sd["classifier.2.bias"]}
    return {"params": p}
