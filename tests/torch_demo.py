"""The committed demo run (``outputs/demo/run``) for the port's tests.

``demo_towers`` rebuilds the demo's fixture tree with the
``tools/demo_run.py`` arguments, loads the JAX engine of the run and writes
the tower parameters the checkpoint does not hold (the seeded ConvNeXt
micro tower, the frozen tiny BERT) to flax bytes, which the port's config
of the run points at through its two weight-path keys.
"""

import os
import shutil

import jax
from flax import serialization

from fixtures import build_image_label_tree
from mmgclip_tpu.config import recompose as jax_recompose
from mmgclip_tpu.serving import InferenceEngine as JaxEngine
from mmgclip_tpu_torch.config import recompose, save_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_RUN = os.path.join(REPO, "outputs", "demo", "run")


def demo_towers(root: str):
    """-> (fixture tree (base, annotated, lists), the JAX engine, text tower
    bytes path, ConvNeXt bytes path)."""
    base, annotated, lists, _ = build_image_label_tree(
        root, n_benign=10, n_malignant=10, image_size=64, feature_store=False,
        pixel_class_signal=True)
    jcfg = jax_recompose(DEMO_RUN)
    jcfg.checkpoints.checkpoints_export_dir = os.path.join(DEMO_RUN, "checkpoints")
    jax_engine = JaxEngine(jcfg)
    text_path = os.path.join(root, "text_tower.msgpack")
    convnext_path = os.path.join(root, "convnext_tower.npz")
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(jax_engine.model.text_variables)))
    with open(convnext_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(jax_engine.encode_params)))
    return (base, annotated, lists), jax_engine, text_path, convnext_path


def port_demo_run(root: str):
    """A run dir of the port under ``root``: the demo's snapshot pointed at
    a rebuilt fixture tree and at the JAX towers' bytes, and a copy of the
    committed checkpoint -> {"root", "run", "cfg", "base"}."""
    (base, annotated, lists), _jax_engine, text_path, convnext_path = demo_towers(
        os.path.join(root, "data"))
    run = os.path.join(root, "run")
    cfg = recompose(DEMO_RUN)
    for key, value in (("dataset.config.base_dataset_path", base),
                       ("dataset.config.annotated_dataset_path", annotated),
                       ("dataset.config.lists_dataset_path", lists),
                       ("base.features_export_dir", os.path.join(root, "data", "encoded")),
                       ("base.export_dir", run),
                       ("base.results_export_dir", os.path.join(run, "results")),
                       ("base.tensorboard_export_dir", os.path.join(run, "runs")),
                       ("checkpoints.checkpoints_export_dir", os.path.join(run, "checkpoints")),
                       ("hydra.run.dir", run),
                       ("networks.image_encoder.convnext_tiny_clf_path", convnext_path),
                       ("networks.text_encoder.weights_path", text_path)):
        cfg.set_path(key, value)
    save_snapshot(cfg, run)
    os.makedirs(os.path.join(run, "checkpoints"))
    shutil.copy(os.path.join(DEMO_RUN, "checkpoints", "model.msgpack"),
                os.path.join(run, "checkpoints", "model.msgpack"))
    return {"root": root, "run": run, "cfg": cfg, "base": base}


def encode_overrides(cfg, run_dir):
    """``encode_images`` arguments that make ``train_binary_class_clf`` the
    demo's encode config (``tools/demo_run.py``'s ``make_cfg``) on the CPU."""
    c = cfg.dataset.config
    return ["--device", "cpu",
            f"dataset.config.base_dataset_path={c.base_dataset_path}",
            f"dataset.config.annotated_dataset_path={c.annotated_dataset_path}",
            f"dataset.config.lists_dataset_path={c.lists_dataset_path}",
            f"base.features_export_dir={cfg.base.features_export_dir}",
            f"networks.image_encoder.convnext_tiny_clf_path={cfg.networks.image_encoder.convnext_tiny_clf_path}",
            "networks.image_encoder.config={micro: true, in_channels: 1}",
            f"hydra.run.dir={run_dir}"]
