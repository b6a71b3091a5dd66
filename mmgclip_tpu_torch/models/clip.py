"""MMGCLIP's serving surface in PyTorch (port of mmgclip_tpu/models/clip.py).

The dual-encoder CLIP head over frozen towers: stored 768-d ConvNeXt
features are flattened (the ``ConvNextTiny`` feature path), the frozen BERT
tower is EOS-pooled, each side goes through its projection head, then
L2-normalization and the learnable logit scale.  Parameters live on the
module (``weights.load_clip_params`` loads the JAX trainable tree).

Not ported yet (ROADMAP.md): the causal/BioGPT text tower, the trainable
ResNet-50 image tower, the training forward and its T2T branch.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config.compose import Config
from ..utils.flax_msgpack import read_file
from ..utils.logging import logger
from .bert import BertConfig, BertEncoder, eos_pool, trim_padded_tail
from .projections import get_projection_head

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "f32": torch.float32,
           "float16": torch.float16, "f16": torch.float16}


def resolve_dtype(name) -> torch.dtype:
    """Config string -> torch dtype ('bfloat16'|'float32'|'float16')."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize as ``x * rsqrt(max(sum(x^2), eps^2))``: finite (zero) at
    zero rows, with a finite gradient there (``F.normalize`` differs)."""
    squared = x.square().sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(squared, min=eps * eps))


def _bert_config_from(config: Config, vocab_size: Optional[int]) -> BertConfig:
    """Size keys, vocab fallback and dtype from ``networks.text_encoder.config``
    (the same keys the JAX package reads)."""
    overrides = config.get_path("networks.text_encoder.config", {}) or {}
    kwargs = {}
    for key in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "max_position_embeddings"):
        if key in overrides:
            kwargs[key] = int(overrides[key])
    if vocab_size is not None and "vocab_size" not in kwargs:
        kwargs["vocab_size"] = int(vocab_size)
    if "dtype" in overrides:
        kwargs["dtype"] = resolve_dtype(overrides["dtype"])
    return BertConfig(**kwargs)


class MMGCLIP(nn.Module):
    """Text tower, projection heads and logit scale of the CLIP model."""

    def __init__(self, config: Config, seed: int = 0, vocab_size: Optional[int] = None):
        super().__init__()
        self.config = config
        self.seed = seed
        image_encoder_name = config.networks.image_encoder.name
        if image_encoder_name != "ConvNextTiny":
            raise NotImplementedError(
                f"image encoder {image_encoder_name!r} is not ported yet; the port "
                "serves the ConvNextTiny feature path (ROADMAP.md, queue 1 item 11)")
        self.image_features_dimension = int(config.networks.image_encoder.image_features_dimension)

        text_encoder_name = str(config.get_path("networks.text_encoder.name", "BertEncoder"))
        if text_encoder_name != "BertEncoder":
            raise NotImplementedError(
                f"text encoder {text_encoder_name!r} is not ported yet (ROADMAP.md, "
                "queue 1 item 11)")
        self.bert_config = _bert_config_from(config, vocab_size)
        self.text_module = BertEncoder(self.bert_config, torch.Generator().manual_seed(seed))
        # converted text-tower weights: flax bytes of {"params": ...}, the
        # JAX package's networks.text_encoder.weights_path contract
        weights_path = str(config.get_path("networks.text_encoder.weights_path", "") or "")
        if weights_path:
            if os.path.isfile(weights_path):
                from ..weights import load_flax_tree

                load_flax_tree(self.text_module, read_file(weights_path)["params"])
                logger.info(f"Loaded converted text-tower weights from {weights_path}.")
            else:
                logger.warning(f"text_encoder.weights_path {weights_path!r} not found; using random init.")
        self.text_output_dimension = self.bert_config.hidden_size
        self.text_pad_trim_multiple = int(
            config.get_path("networks.text_encoder.config.pad_trim_multiple", 32))

        projection_name = config.projection.config.projection_name
        self.projection_name = projection_name
        dropout = float(config.get_path("networks.dropout.config.dropout", 0.0))
        self.image_projection = None
        self.text_projection = None
        if projection_name != "ZeroProjection":
            head_cls = get_projection_head(projection_name)
            proj_dim = config.projection.config.output_projection_dimension
            self.image_projection = head_cls(
                self.image_features_dimension, proj_dim, dropout,
                generator=torch.Generator().manual_seed(seed + 2))
            self.text_projection = head_cls(
                self.text_output_dimension, proj_dim, dropout,
                generator=torch.Generator().manual_seed(seed + 3))
            logger.info(f"Embeddings projected to {proj_dim} features using {projection_name}.")
        temperature = float(config.networks.logit_temperature)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / temperature), dtype=torch.float32))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def apply_image_tower(self, image_features: torch.Tensor) -> torch.Tensor:
        """Stored ConvNeXt features -> flat [n, d]."""
        return image_features.reshape(image_features.shape[0], -1)

    def apply_text_tower(self, text_tokens: Dict) -> torch.Tensor:
        """Frozen BERT -> EOS pooling.  Token arrays (numpy or tensors) get
        their all-padding tail trimmed first (exact)."""
        text_tokens = trim_padded_tail(text_tokens, self.text_pad_trim_multiple)
        tensors = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                      device=self.device)
                   for k, v in text_tokens.items()}
        hidden = self.text_module(tensors["input_ids"], attention_mask=tensors["attention_mask"],
                                  token_type_ids=tensors.get("token_type_ids"))
        return eos_pool(hidden, tensors["attention_mask"])

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return features if self.image_projection is None else self.image_projection(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return features if self.text_projection is None else self.text_projection(features)

