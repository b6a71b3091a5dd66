"""MMGCLIP in PyTorch (port of mmgclip_tpu/models/clip.py).

The dual-encoder CLIP head over frozen towers: stored 768-d ConvNeXt
features are flattened (the ``ConvNextTiny`` feature path), the frozen BERT
tower is EOS-pooled, each side goes through its projection head, then
L2-normalization and the learnable logit scale.  Parameters live on the
module (``weights.load_clip_params`` loads the JAX trainable tree,
``weights.clip_params_tree`` writes it back).  The text tower is frozen
(``requires_grad=False``); the trainable set is the heads plus
``logit_scale`` (``trainable_parameters``), as in the JAX package.
``forward(train=True)`` applies head dropout from an explicit
``torch.Generator`` and adds the T2T branch for ``MMGCLIPLoss``.

Not ported yet (ROADMAP.md): the causal/BioGPT text tower and the trainable
ResNet-50 image tower.
"""

from __future__ import annotations

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
                "serves the ConvNextTiny feature path (ROADMAP.md, queue 1 item 9)")
        self.image_encoder_name = image_encoder_name
        self.image_features_dimension = int(config.networks.image_encoder.image_features_dimension)

        text_encoder_name = str(config.get_path("networks.text_encoder.name", "BertEncoder"))
        if text_encoder_name != "BertEncoder":
            raise NotImplementedError(
                f"text encoder {text_encoder_name!r} is not ported yet (ROADMAP.md, "
                "queue 1 item 9)")
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
        self.text_module.requires_grad_(False)  # frozen: its features are cached once
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
        self.logit_scale = nn.Parameter(
            torch.tensor(np.log(1.0 / temperature), dtype=torch.float32))
        self.loss_name = str(config.get_path("loss.config.loss_name", "CLIPLoss"))

    def trainable_parameters(self) -> Dict[str, nn.Parameter]:
        """Dotted name -> parameter of the heads and ``logit_scale``: the JAX
        ``trainable_params`` tree, flattened."""
        out: Dict[str, nn.Parameter] = {}
        for name in ("image_projection", "text_projection"):
            head = getattr(self, name)
            if head is not None:
                out.update({f"{name}.{key}": p for key, p in head.named_parameters()})
        out["logit_scale"] = self.logit_scale
        return out

    def count_parameters(self) -> int:
        total = sum(p.numel() for p in self.trainable_parameters().values())
        logger.info(f"Total Trainable Params: {total}")
        return total

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

    def project_image(self, features: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.image_projection is None:
            return features
        return self.image_projection(features, train=train, generator=generator)

    def project_text(self, features: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.text_projection is None:
            return features
        return self.text_projection(features, train=train, generator=generator)

    def forward(self, batch: Optional[Dict] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, validation: bool = False,
                text_features: Optional[torch.Tensor] = None,
                text_features2: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Full forward (reference: mmgclip_model.py:117-166).

        ``text_features`` / ``text_features2`` short-circuit the frozen text
        tower with cached EOS-pooled activations.  Dropout masks come from
        ``generator`` in the order image head, text head, second text head."""
        batch = batch or {}
        image_features = self.apply_image_tower(batch["image_features"])
        if text_features is None:
            text_features = self.apply_text_tower(batch["text_tokens"])
        image_embeddings = l2_normalize(self.project_image(image_features, train, generator))
        text_embeddings = l2_normalize(self.project_text(text_features, train, generator))

        logit_scale = torch.exp(self.logit_scale)
        output = {
            "image_embeddings": image_embeddings,
            "text_embeddings": text_embeddings,
            "logit_scale": logit_scale,
            "logits_per_image": logit_scale * image_embeddings @ text_embeddings.T,
            "logits_per_text": logit_scale * text_embeddings @ image_embeddings.T,
        }
        # second text pass for the T2T term (reference: mmgclip_model.py:154-164)
        if self.loss_name == "MMGCLIPLoss" and not validation:
            if text_features2 is None and "image_impression_tokens" in batch:
                text_features2 = self.apply_text_tower(batch["image_impression_tokens"])
            if text_features2 is not None:
                output["text_embeddings2"] = l2_normalize(
                    self.project_text(text_features2, train, generator))
        return output

