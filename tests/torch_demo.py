"""The committed demo run (``outputs/demo/run``) for the port's tests.

``demo_towers`` rebuilds the demo's fixture tree with the
``tools/demo_run.py`` arguments, loads the JAX engine of the run and writes
the tower parameters the checkpoint does not hold (the seeded ConvNeXt
micro tower, the frozen tiny BERT) to flax bytes, which the port's config
of the run points at through its two weight-path keys.
"""

import os

import jax
from flax import serialization

from fixtures import build_image_label_tree
from mmgclip_tpu.config import recompose as jax_recompose
from mmgclip_tpu.serving import InferenceEngine as JaxEngine

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
