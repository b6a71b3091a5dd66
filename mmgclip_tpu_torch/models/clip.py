"""MMGCLIP in PyTorch (port of mmgclip_tpu/models/clip.py).

The dual-encoder CLIP head over frozen towers: stored 768-d ConvNeXt
features are flattened (the ``ConvNextTiny`` feature path) or re-encoded by
the ResNet-50 tower (``ResNet50Encoder``, the ablation path, whose
``layer4`` trains), the frozen text tower (BERT, or the causal
BioGPT-family ``CausalTextEncoder``) is EOS-pooled, each side goes through
its projection head, then L2-normalization and the learnable logit scale.
Parameters live on the module (``weights.load_clip_params`` loads the JAX
trainable tree, ``weights.clip_params_tree`` writes it back).  The text
tower is frozen (``requires_grad=False``); the trainable set is the heads,
``logit_scale`` and, with the ResNet, every ``image_encoder`` parameter
(``trainable_parameters``), as in the JAX package; of the ResNet only
``layer4`` has ``requires_grad`` (``training.optim.resnet_finetune_mask``),
so the backward stops there.
``forward(train=True)`` splits the step's threefry key three ways (image
head, text head, second text head) and applies flax's head dropout under
them, and adds the T2T branch for ``MMGCLIPLoss``.
``PromptClassifier`` is the zero-shot wrapper over a model.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config.compose import Config
from ..ops import dropout as dropout_op
from ..utils.flax_msgpack import read_file
from ..utils.logging import logger
from .bert import BertConfig, BertEncoder, eos_pool, trim_padded_tail
from .gpt import CausalTextEncoder, GPTConfig
from .projections import get_projection_head
from .resnet import ResNet50Encoder, ResNetConfig

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


CAUSAL_TEXT_ENCODERS = ("CausalTextEncoder", "BioGptEncoder", "GPTEncoder")


def _text_tower_config_from(config: Config, vocab_size: Optional[int], config_cls):
    """Size keys, vocab fallback and dtype from ``networks.text_encoder.config``
    (the same keys the JAX package reads) -> ``BertConfig`` / ``GPTConfig``."""
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
    return config_cls(**kwargs)


class MMGCLIP(nn.Module):
    """Text tower, projection heads and logit scale of the CLIP model."""

    def __init__(self, config: Config, seed: int = 0, vocab_size: Optional[int] = None):
        super().__init__()
        self.config = config
        self.seed = seed
        self.image_encoder_name = config.networks.image_encoder.name
        self.image_features_dimension = int(config.networks.image_encoder.image_features_dimension)
        # the optional trainable image tower (the ResNet-50 ablation path);
        # ``micro`` is the key the ConvNeXt encode tower reads too
        self.image_module = None
        image_tower_dim = self.image_features_dimension
        if self.image_encoder_name == "ResNet50Encoder":
            overrides = config.get_path("networks.image_encoder.config", {}) or {}
            rn_config = ResNetConfig.micro() if overrides.get("micro") else ResNetConfig.resnet50()
            self.image_module = ResNet50Encoder(rn_config, torch.Generator().manual_seed(seed + 1))
            image_tower_dim = self.image_module.output_dimension  # width * 32
            logger.info("Using ResNet50Encoder image tower.")

        # frozen text tower: BERT-family, or causal (BioGPT-family) by name
        text_encoder_name = str(config.get_path("networks.text_encoder.name", "BertEncoder"))
        tower = ((GPTConfig, CausalTextEncoder) if text_encoder_name in CAUSAL_TEXT_ENCODERS
                 else (BertConfig, BertEncoder))
        self.bert_config = _text_tower_config_from(config, vocab_size, tower[0])
        self.text_module = tower[1](self.bert_config, torch.Generator().manual_seed(seed))
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
            # the head's own knobs from the projection config (MoE: n_experts...)
            extra = {key: config.projection.config[key] for key in getattr(head_cls, "EXTRA_KNOBS", ())
                     if key in config.projection.config}
            self.image_projection = head_cls(
                image_tower_dim, proj_dim, dropout,
                generator=torch.Generator().manual_seed(seed + 2), **extra)
            self.text_projection = head_cls(
                self.text_output_dimension, proj_dim, dropout,
                generator=torch.Generator().manual_seed(seed + 3), **extra)
            logger.info(f"Embeddings projected to {proj_dim} features using {projection_name}.")
        temperature = float(config.networks.logit_temperature)
        self.logit_scale = nn.Parameter(
            torch.tensor(np.log(1.0 / temperature), dtype=torch.float32))
        self.loss_name = str(config.get_path("loss.config.loss_name", "CLIPLoss"))
        if self.image_module is not None:
            from ..training.optim import resnet_finetune_mask

            params = self.trainable_parameters()
            for name, trainable in resnet_finetune_mask(params).items():
                params[name].requires_grad_(trainable)

    def trainable_parameters(self) -> Dict[str, nn.Parameter]:
        """Dotted name -> parameter of the heads, ``logit_scale`` and the
        ResNet tower (``image_encoder.*``, its frozen stages included): the
        JAX ``trainable_params`` tree, flattened."""
        out: Dict[str, nn.Parameter] = {}
        for name in ("image_projection", "text_projection"):
            head = getattr(self, name)
            if head is not None:
                out.update({f"{name}.{key}": p for key, p in head.named_parameters()})
        out["logit_scale"] = self.logit_scale
        if self.image_module is not None:
            out.update({f"image_encoder.{key}": p for key, p in self.image_module.named_parameters()})
        return out

    def count_parameters(self) -> int:
        total = sum(p.numel() for p in self.trainable_parameters().values())
        logger.info(f"Total Trainable Params: {total}")
        return total

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def apply_image_tower(self, image_features: torch.Tensor) -> torch.Tensor:
        """Stored features (``[n, D]`` or ``[n, 1, D, 1, 1]``) -> flat ``[n, D]``;
        the ResNet path re-encodes them to ``[n, width * 32]`` (BatchNorm on
        its running statistics: PARITY.md #8, ``models/resnet.py``)."""
        flat = image_features.reshape(image_features.shape[0], -1)
        return flat if self.image_module is None else self.image_module(flat)

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
                      key: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.image_projection is None:
            return features
        return self.image_projection(features, train=train, key=key)

    def project_text(self, features: torch.Tensor, train: bool = False,
                     key: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.text_projection is None:
            return features
        return self.text_projection(features, train=train, key=key)

    def embed(self, head: Optional[nn.Module], features: torch.Tensor, key: Optional[torch.Tensor],
              image: bool, train: bool = False) -> torch.Tensor:
        """The normalized embeddings of stored ``features`` through ``head``
        (``None``: no head), the image tower first when ``image``."""
        if image:
            features = self.apply_image_tower(features)
        return l2_normalize(features if head is None else head(features, train=train, key=key))

    def forward(self, batch: Optional[Dict] = None, train: bool = False,
                key: Optional[torch.Tensor] = None, validation: bool = False,
                text_features: Optional[torch.Tensor] = None,
                text_features2: Optional[torch.Tensor] = None,
                embed: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """Full forward (reference: mmgclip_model.py:117-166).

        ``text_features`` / ``text_features2`` short-circuit the frozen text
        tower with cached EOS-pooled activations.  ``key``: the step's
        threefry key (an int64 ``[2]`` tensor on the model's device), split
        into the image, text and second text heads' dropout keys as the JAX
        model splits its ``rng``.  ``embed(head, features, key, image)``
        takes the place of ``self.embed`` (the data-parallel trainer's,
        which projects this rank's rows and gathers the batch's)."""
        batch = batch or {}
        if embed is None:
            def embed(head, features, head_key, image):
                return self.embed(head, features, head_key, image, train)
        if text_features is None:
            text_features = self.apply_text_tower(batch["text_tokens"])
        # jax.random.split(key, 3): the image, text and second text heads' dropout keys
        key_img, key_txt, key_txt2 = (None,) * 3 if key is None else dropout_op.split(key, 3)
        image_embeddings = embed(self.image_projection, batch["image_features"], key_img, True)
        text_embeddings = embed(self.text_projection, text_features, key_txt, False)

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
                output["text_embeddings2"] = embed(self.text_projection, text_features2, key_txt2, False)
        return output


class PromptClassifier:
    """Zero-shot wrapper (reference: mmgclip_model.py:168-249; port of the
    JAX package's ``PromptClassifier``).

    Tokenizes a prompt list, runs the text tower and head once per list
    (cached), and softmaxes ``logit_scale · img @ textᵀ`` once.  The cache is
    dropped when the parameters change: assigning ``params`` (a JAX-layout
    trainable tree, loaded in place) or any in-place update of the model's
    trainable tensors, such as a training step, bumps their version.
    ``similarities_argmax`` is the first image's (quirk Q10, the reference's
    ``argmax(...)[0].item()``); ``similarities_argmax_per_image`` holds all.
    """

    def __init__(self, model: MMGCLIP, tokenizer, params: Optional[Dict] = None):
        self.model = model
        self.tokenizer = tokenizer
        self._text_cache: Dict[tuple, torch.Tensor] = {}
        self._cache_version = None
        if params is not None:
            self.params = params

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return self.model.trainable_parameters()

    @params.setter
    def params(self, tree: Dict) -> None:
        from ..weights import load_clip_params

        load_clip_params(self.model, tree)

    def _params_version(self) -> tuple:
        return tuple((id(p), p._version) for p in self.model.trainable_parameters().values())

    @torch.no_grad()
    def encode_prompts(self, class_list) -> torch.Tensor:
        version = self._params_version()
        if version != self._cache_version:
            # cached embeddings would mix old text with new image projections
            self._text_cache.clear()
            self._cache_version = version
        key = tuple(class_list)
        if key not in self._text_cache:
            tokens = self.tokenizer(list(class_list), padding="max_length", truncation=True,
                                    max_length=int(self.model.config.tokenizer.config.sequence_length))
            pooled = self.model.apply_text_tower(tokens)
            self._text_cache[key] = l2_normalize(self.model.project_text(pooled, train=False))
        return self._text_cache[key]

    @torch.no_grad()
    def __call__(self, image_features, class_list, visualize: bool = False, **_) -> Dict:
        feats = torch.as_tensor(np.asarray(image_features, np.float32), device=self.model.device)
        if feats.ndim == 1:
            feats = feats[None, :]
        feats = self.model.apply_image_tower(feats)
        image_embeddings = l2_normalize(self.model.project_image(feats, train=False))
        text_embeddings = self.encode_prompts(class_list)
        logits = torch.exp(self.model.logit_scale) * image_embeddings @ text_embeddings.T
        sims = torch.softmax(logits, dim=-1)
        argmax = torch.argmax(sims, dim=-1).cpu().tolist()  # one read back for all images
        return {
            "classes_similarities": sims,
            "similarities_argmax": int(argmax[0]),
            "similarities_argmax_per_image": [int(v) for v in argmax],
            "class_list": list(class_list),
        }
