"""The encode program shared by serving and reports (port of the serving half
of mmgclip_tpu/ingest/encode.py).

``load_convnext_tower`` builds ConvNeXt-Tiny from the same config knobs as the
JAX package and loads converted weights (flax bytes at
``networks.image_encoder.convnext_tiny_clf_path``, ``.npz`` suffix) with the
port's own reader; without the file the tower keeps its seeded init.
``build_encode_program`` returns ``[n, H, W] uint8/uint16 -> [n, d]``:
intensity transform (optionally windowed) then the tower.

Not ported yet (ROADMAP.md, queue 1 items 3 and 9): the resize chain
(``encode_resize``, ``encode_host_prepool``, windowing after a resize) and
the masked bucketed tower path behind it — they raise
``NotImplementedError`` — and the feature-store extractors.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional

import torch

from ..models.clip import resolve_dtype
from ..models.convnext import ConvNeXt, ConvNeXtConfig
from ..ops.preprocess import intensity_transform
from ..utils.flax_msgpack import read_file
from ..utils.logging import logger

_RESIZE_TODO = "ROADMAP.md, queue 1 item 9 (the resize/prepool ingest chain)"


def load_convnext_tower(config, seed: int = 0, device="cpu"):
    """-> (module on ``device`` in eval mode, ConvNeXtConfig)."""
    path = str(config.networks.image_encoder.convnext_tiny_clf_path or "")
    overrides = config.get_path("networks.image_encoder.config", {}) or {}
    cn_config = ConvNeXtConfig.micro() if overrides.get("micro") else ConvNeXtConfig.tiny()
    if overrides.get("in_channels"):
        cn_config = replace(cn_config, in_channels=int(overrides["in_channels"]))
    if overrides.get("dtype"):
        cn_config = replace(cn_config, dtype=resolve_dtype(overrides["dtype"]))
    if overrides.get("quant"):
        raise NotImplementedError(
            "networks.image_encoder.config.quant (the int8 block kernel) is not "
            "ported yet (ROADMAP.md, queue 2)")
    if overrides.get("use_fused_blocks"):
        cn_config = replace(cn_config, use_fused_blocks=True)
    if overrides.get("fuse_stem") or overrides.get("fuse_downsample"):
        # same math either way; only the kernel that runs it differs
        logger.warning(
            "fuse_stem/fuse_downsample: the PyTorch port runs the plain stem and "
            "downsample (identical math) until those kernels are ported "
            "(ROADMAP.md, queue 2).")
    if overrides.get("gelu"):
        gelu = str(overrides["gelu"])
        if gelu not in ("exact", "tanh"):
            raise ValueError(
                "networks.image_encoder.config.gelu must be 'exact' or "
                f"'tanh', got {gelu!r}")
        cn_config = replace(cn_config, gelu=gelu)
    tree = None
    if path and os.path.isfile(path) and path.endswith(".npz"):
        tree = read_file(path)
        # the stored stem kernel is the source of truth for the input channels
        stem_in = int(tree["params"]["stem_conv"]["kernel"].shape[2])
        if stem_in != cn_config.in_channels:
            logger.info(f"Converted stem expects {stem_in} input channel(s); adapting "
                        f"tower config (was {cn_config.in_channels}).")
            cn_config = replace(cn_config, in_channels=stem_in)
    module = ConvNeXt(cn_config, torch.Generator().manual_seed(seed))
    if tree is not None:
        from ..weights import load_flax_tree

        load_flax_tree(module, tree["params"])
        logger.info(f"Loaded ConvNeXt weights from {path}.")
    else:
        logger.warning(f"ConvNeXt weight file {path!r} not found; using seeded random init.")
    return module.to(device).eval(), cn_config


def parse_ingest_knobs(config):
    """``dataset.config.encode_*`` -> ``(resize_hw, resize_method,
    resize_precision, window, prepool)``, validated as in the JAX package
    (``resize_precision`` is the string ``"highest"`` or None)."""
    resize = config.get_path("dataset.config.encode_resize", None)
    if resize is None:
        resize_hw = None
    elif isinstance(resize, (list, tuple)):
        resize_hw = (int(resize[0]), int(resize[1]))
    else:
        resize_hw = (int(resize), int(resize))
    resize_method = str(config.get_path("dataset.config.encode_resize_method", "area") or "area")
    precision = str(config.get_path("dataset.config.encode_resize_precision", "default") or "default")
    if precision not in ("default", "highest"):
        raise ValueError(
            "dataset.config.encode_resize_precision must be 'default' or "
            f"'highest', got {precision!r}")
    resize_precision = "highest" if precision == "highest" else None
    window = config.get_path("dataset.config.encode_window", None)
    window = (float(window[0]), float(window[1])) if window else None
    prepool = int(config.get_path("dataset.config.encode_host_prepool", 0) or 0)
    if prepool:
        if not 2 <= prepool <= 16:
            raise ValueError(
                "dataset.config.encode_host_prepool must be in [2, 16] "
                f"(block sums must fit uint16/uint32), got {prepool}")
        if resize_hw is None:
            raise ValueError(
                "dataset.config.encode_host_prepool requires "
                "dataset.config.encode_resize")
    return resize_hw, resize_method, resize_precision, window, prepool


def build_encode_program(module, in_ch: int, window=None, resize_hw=None,
                         resize_method: str = "area", resize_precision: Optional[str] = None,
                         prepool: int = 0):
    """The ``[n, H, W] uint8/uint16 tensor -> [n, d] features`` program (on
    the module's device): intensity transform (optionally windowed), then
    the tower.  The resize chain raises ``NotImplementedError``."""
    del resize_method, resize_precision  # only read by the resize chain
    if resize_hw is not None or prepool:
        raise NotImplementedError(
            "dataset.config.encode_resize / encode_host_prepool are not ported "
            f"yet ({_RESIZE_TODO})")

    @torch.inference_mode()
    def encode(pixels: torch.Tensor) -> torch.Tensor:
        x = intensity_transform(pixels, window=window)[..., None]
        if in_ch > 1:
            x = x.repeat_interleave(in_ch, dim=-1)
        return module(x)  # pooled [n, d]

    return encode
