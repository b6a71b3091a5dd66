"""Pieces the generators share: the port's config from a configuration file,
precision flags, seeded weights in the port's files, and the comparisons."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..data import flax_bytes, weights


def set_precision(config: Dict) -> None:
    """TF32 on or off for the port's float32 matmuls and convolutions, as the
    configuration states it (``tf32``)."""
    import torch

    on = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def compose(config: Dict, workdir: str, extra: Sequence[str] = ()):
    """The port's config: the stock preset with the configuration's
    overrides, then ``extra``; run files under ``workdir/run``."""
    from mmgclip_tpu_torch.cli import DEFAULT_CONFIG_DIR
    from mmgclip_tpu_torch.config import compose as port_compose

    run_dir = os.path.join(workdir, "run")
    cfg = port_compose(DEFAULT_CONFIG_DIR, config["preset"], list(config["overrides"]) + list(extra),
                       run_dir=run_dir)
    cfg.base.tensorboard_export_dir = os.path.join(run_dir, "tb")
    return cfg


def convnext_weights(config: Dict, seed: int, device: str, path: str) -> Dict:
    """ConvNeXt's tree from the seed, written as the ``.npz`` flax file the
    port's ``convnext_tiny_clf_path`` names; returns the float32 values.

    ``ln_outliers``: in every block, that share of the LayerNorm's channels
    (seeded) gets the scale ``scale``: the few outlier channels trained
    ConvNeXts and transformers carry into their pointwise products."""
    tower = config["image_tower"]
    maker = weights.convnext_tree(tower["depths"], tower["dims"], tower["in_channels"],
                                  tower["num_classes"], tower["layer_scale"])
    values, file_tree = maker.make(weights.tree_seed(seed, "convnext"), device, bf16=True)
    outliers = tower.get("ln_outliers")
    if outliers:
        rng = np.random.default_rng([int(seed), 4])
        bits = np.float32(outliers["scale"]).view(np.uint32) >> 16
        for s, (depth, dim) in enumerate(zip(tower["depths"], tower["dims"])):
            count = max(1, int(round(outliers["share"] * dim)))
            for i in range(depth):
                channels = rng.choice(dim, size=count, replace=False)
                values[f"stage_{s}"]["norm_scale"][i, channels] = outliers["scale"]
                file_tree[f"stage_{s}"]["norm_scale"].bits[i, channels] = bits
    flax_bytes.write(path, {"params": file_tree})
    return values


def bert_weights(config: Dict, seed: int, device: str, path: str) -> Dict:
    """BERT's tree from the seed, written as the flax file
    ``networks.text_encoder.weights_path`` names (bfloat16-exact values,
    half the bytes of float32); returns the float32 values."""
    t = config["text_tower"]
    maker = weights.bert_tree(t["vocab_size"], t["hidden_size"], t["num_hidden_layers"],
                              t["num_attention_heads"], t["intermediate_size"],
                              t["max_position_embeddings"], t["type_vocab_size"])
    values, file_tree = maker.make(weights.tree_seed(seed, "bert"), device, bf16=True)
    flax_bytes.write(path, {"params": file_tree})
    return values


def text_overrides(config: Dict, vocab_path: str, bert_path: str) -> List[str]:
    t = config["text_tower"]
    sizes = ", ".join(f"{k}: {t[k]}" for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                               "num_attention_heads", "intermediate_size",
                                               "max_position_embeddings"))
    return [f"tokenizer.config.tokenizer_name={vocab_path}",
            f"tokenizer.config.sequence_length={t['sequence_length']}",
            f"networks.text_encoder.weights_path={bert_path}",
            "networks.text_encoder.config={" + sizes + "}"]


def sample(seed: int, population: int, k: int, salt: int) -> List[int]:
    """``k`` distinct indices of ``range(population)`` drawn from the seed."""
    rng = np.random.default_rng([int(seed), salt])
    return sorted(rng.choice(population, size=min(k, population), replace=False).tolist())


def one_minus_cos(port: np.ndarray, ref: np.ndarray) -> float:
    """1 - the cosine between two feature vectors, in float64."""
    port, ref = np.asarray(port, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return 1.0 - float(port @ ref / max(np.linalg.norm(port) * np.linalg.norm(ref), 1e-30))
