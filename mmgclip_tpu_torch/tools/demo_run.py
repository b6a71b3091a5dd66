"""Reproducible end-to-end demo run on synthetic fixtures, through the port's
entry points (port of tools/demo_run.py).

    python -m mmgclip_tpu_torch.tools.demo_run [--out outputs/demo_torch] [--device cpu]

The JAX tool's workflow with fixed seeds, under ``<out>/run`` (the fixture
tree and feature store under ``<out>/data``): ``encode_images`` -> ``train``
(``test()``: ``results.txt`` / ``results.json`` + ROC/CI PNGs) ->
``generate_report`` (bug-compat and semantic) -> one served ``classify``
request -> ``tsne_eval`` -> a second run (MLP projection) and
``compare_runs`` -> ``MANIFEST.txt``.  Everything comes from seeds.  It
never writes the JAX tool's committed ``outputs/demo/run``; ``--out`` is
cleared first.  Runs on the CUDA card unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import List, Optional

from .. import encode_images, train
from ..cli import DEFAULT_CONFIG_DIR
from ..config import Config, compose, save_snapshot
from ..data.paths import create_path
from ..data.tokenizer import Tokenizer
from ..evaluation.report_cascade import decide
from ..evaluation.report_text import generate_report
from ..generate_report import encode_inputs
from ..ingest.encode import resolve_device
from ..models.clip import MMGCLIP
from ..serving import InferenceEngine
from ..training.checkpoint import load_checkpoint
from ..utils.seeding import seeding
from ..weights import load_clip_params
from . import compare_runs, tsne_eval
from .fixtures import build_image_label_tree, make_image_id

REPO = os.path.dirname(DEFAULT_CONFIG_DIR)
CLASS_LIST = ["Finding suggesting benign.", "Finding suggesting malignant."]


def demo_config(run_dir: str, data: str, tree) -> Config:
    """``train_binary_class_clf`` at the demo's sizes (the JAX tool's
    ``make_cfg``): micro 1-channel tower, BERT 2 x 64, 4 epochs."""
    base, annotated, lists_dir = tree
    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf", run_dir=run_dir)
    cfg.dataset.config.base_dataset_path = base
    cfg.dataset.config.annotated_dataset_path = annotated
    cfg.dataset.config.lists_dataset_path = lists_dir
    cfg.base.features_export_dir = os.path.join(data, "encoded")
    cfg.base.export_dir = run_dir
    cfg.base.results_export_dir = os.path.join(run_dir, "results")
    cfg.base.tensorboard_export_dir = os.path.join(run_dir, "runs")
    cfg.checkpoints.checkpoints_export_dir = os.path.join(run_dir, "checkpoints")
    cfg.tokenizer.config.sequence_length = 32
    cfg.networks.text_encoder = Config({
        "name": "BertEncoder",
        "config": {"vocab_size": 4096, "hidden_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "intermediate_size": 128,
                   "max_position_embeddings": 64},
    })
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    cfg.scheduler.config.epochs = 4
    cfg.dataloader.train.batch_size = 4
    cfg.dataloader.valid.batch_size = 2
    cfg.dataloader.test.batch_size = 2
    return cfg


def main(argv: Optional[List[str]] = None) -> str:
    """The entry point; returns the run directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(REPO, "outputs", "demo_torch"),
                        help="Directory to (re)create; the run goes to <out>/run.")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    out = os.path.abspath(args.out)
    if os.path.commonpath([out, os.path.join(REPO, "outputs", "demo")]) == os.path.join(
            REPO, "outputs", "demo"):
        raise SystemExit(f"refusing --out {out}: outputs/demo holds the JAX tool's committed run")
    run, data = os.path.join(out, "run"), os.path.join(out, "data")
    for path in (run, data):
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)

    base, annotated, lists_dir, _ = build_image_label_tree(
        data, n_benign=10, n_malignant=10, image_size=64, feature_store=False,
        pixel_class_signal=True)
    tree = (base, annotated, lists_dir)
    cfg = demo_config(run, data, tree)
    save_snapshot(cfg, run)

    print("== encode_images ==")
    encode_images.extract(cfg, device=device)

    print("== train ==")
    train.run(cfg, device=device)

    print("== generate_report ==")
    tokenizer = Tokenizer.from_pretrained(cfg.tokenizer.config.tokenizer_name, sequence_length=32)
    model = MMGCLIP(cfg, seed=int(cfg.base.seed), vocab_size=tokenizer.vocab_size)
    load_clip_params(model, load_checkpoint(
        os.path.join(cfg.checkpoints.checkpoints_export_dir, "model.msgpack"))["params"])
    model.to(device).eval()
    image_id = make_image_id(2000000, 2, "cl")
    decisions = decide(model, tokenizer, encode_inputs(cfg, image_id=image_id, device=device))
    seed = int(cfg.base.seed)
    compat_text, _ = generate_report(decisions, rng=seeding(seed).host, bug_compat=True)
    semantic_text, _ = generate_report(decisions, rng=seeding(seed).host, bug_compat=False)
    with open(os.path.join(run, "generated_report.txt"), "w") as fh:
        fh.write(f"image_id: {image_id}\n")
        fh.write(f"decisions: {json.dumps(decisions)}\n\n")
        fh.write(f"[bug_compat=true]  {compat_text}\n")
        fh.write(f"[bug_compat=false] {semantic_text}\n")
    print("report:", compat_text)

    print("== serve (one request) ==")
    engine = InferenceEngine.from_experiment(run, device=device)
    png = create_path(image_id, base_dataset_path=base)
    result = engine.classify(engine.encode_paths([png]), CLASS_LIST)
    engine.close()
    with open(os.path.join(run, "served_request.json"), "w") as fh:
        json.dump({"request": {"op": "classify", "paths": [png], "class_list": CLASS_LIST},
                   "response": result}, fh, indent=2)

    print("== tsne ==")
    tsne_eval.main(["--experiment_path", run, "--device", str(device)])

    print("== second config (MLP projection) + compare_runs ==")
    # a second short experiment on the same features; only the comparison
    # is kept (under run/comparison)
    run2 = os.path.join(out, "run_mlp")
    shutil.rmtree(run2, ignore_errors=True)
    cfg2 = demo_config(run2, data, tree)
    cfg2.projection.config.projection_name = "MLPProjectionHead"
    save_snapshot(cfg2, run2)
    train.run(cfg2, device=device)
    compare_runs.compare_runs([run, run2], labels=["linear512", "mlp512"],
                              out_dir=os.path.join(run, "comparison"))
    shutil.rmtree(run2, ignore_errors=True)

    manifest = []
    for root, _dirs, files in os.walk(run):
        for name in sorted(files):
            rel = os.path.relpath(os.path.join(root, name), run)
            if not rel.startswith("runs/"):
                manifest.append(rel)
    with open(os.path.join(run, "MANIFEST.txt"), "w") as fh:
        fh.write("\n".join(sorted(manifest)) + "\n")
    print("== artifacts ==")
    print("\n".join(sorted(manifest)))
    return run


if __name__ == "__main__":
    main()
