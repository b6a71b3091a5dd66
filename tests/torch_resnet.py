"""The ResNet-50 family's shared fixture pieces for the port's slice tests
(``test_torch_resnet_train.py``, ``test_torch_resnet_report.py``)."""

import os

import jax
from flax import serialization

from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL = 1e-5
EPOCHS = 3


def overrides(tree, run_dir, text_path, convnext_path=""):
    """The slice's config: ``convnext_path`` holds the micro ConvNeXt tower's
    flax bytes that ``generate_report`` encodes PNGs with."""
    base, annotated, lists, features = tree
    return [
        "networks=clip_resnet50_bert", "networks.image_encoder.config={micro: true}",
        f"networks.image_encoder.convnext_tiny_clf_path={convnext_path}",
        "dataset.config.concatenate_features_method=avgpool",
        "networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, "
        "num_attention_heads: 2, intermediate_size: 64, max_position_embeddings: 64}",
        f"networks.text_encoder.weights_path={text_path}",
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        "tokenizer.config.sequence_length=32", f"scheduler.config.epochs={EPOCHS}",
        "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
        "dataloader.valid.shuffle=false", "dataloader.test.batch_size=2",
    ]


def write_text_tower(jcfg, path):
    """The JAX model of ``jcfg`` built as its trainer builds it: its frozen
    text tower to flax bytes at ``path``; -> its initial trainable tree."""
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name, sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    return jax.device_get(model.trainable_params)


def ckpt(cfg):
    return os.path.join(cfg.checkpoints.checkpoints_export_dir, cfg.checkpoints.checkpoints_file_name)


def close_results(ours, theirs, path=""):
    """results.json: floats within TOL, everything else equal."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for key in theirs:
            close_results(ours[key], theirs[key], f"{path}/{key}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            close_results(a, b, f"{path}/{i}")
    elif isinstance(theirs, float):
        assert abs(ours - theirs) <= TOL, (path, ours, theirs)
    else:
        assert ours == theirs, (path, ours, theirs)
