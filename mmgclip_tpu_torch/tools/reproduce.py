"""One-command reproduction from the reference's torch artifacts: convert ->
encode -> train -> evaluate -> report (port of tools/reproduce.py).

The reference's product path starts from a TorchScript ConvNeXt classifier
and an HF BERT snapshot.  Given those files, this runs the whole flow:

    python -m mmgclip_tpu_torch.tools.reproduce \
        --convnext /path/to/classifier_convnext_tiny.pt \
        --bert /path/to/hf_bert_snapshot \
        --base-data /path/to/base --annotated-data /path/to/annotated \
        --lists-data /path/to/lists [--out outputs/reproduce] [--device cpu]

Offline rehearsal (synthesizes torch artifacts in the same file layouts and
a PNG tree, then runs the same steps):

    python -m mmgclip_tpu_torch.tools.reproduce --fixtures [--device cpu]

Steps:
  1. ``tools.convert_convnext``  (TorchScript/.pt -> flax .npz, ``--verify``)
  2. ``tools.convert_bert``      (HF dir -> flax .msgpack)
  3. ``encode_images.extract``   (the feature store through the converted tower)
  4. ``train.run``               (projection training over the frozen towers,
                                  ``test()`` when configured)
  5. ``generate_report``         (the cascade over one stored feature vector)

``--out`` is cleared only when this tool created it (its
``.mmgclip_reproduce_run`` marker) or when it is empty.  Runs on the CUDA
card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import encode_images, train
from ..cli import DEFAULT_CONFIG_DIR
from ..config import Config, compose, save_snapshot
from ..data.tokenizer import Tokenizer
from ..evaluation.report_cascade import decide
from ..evaluation.report_text import generate_report
from ..ingest.encode import resolve_device
from ..models.clip import MMGCLIP
from ..training.checkpoint import load_checkpoint
from ..utils.seeding import seeding
from ..weights import load_clip_params
from . import convert_bert, convert_convnext
from .fixtures import build_image_label_tree, make_torch_fixtures

REPO = os.path.dirname(DEFAULT_CONFIG_DIR)
MARKER = ".mmgclip_reproduce_run"


def prepare_out(run: str) -> None:
    """Create ``run`` with the marker, clearing it only when this tool made
    it (marker present) or it is empty."""
    marker = os.path.join(run, MARKER)
    if os.path.exists(run):
        # never an arbitrary user path: `--out .` must not delete the cwd
        if os.path.isfile(marker):
            shutil.rmtree(run)
        elif not (os.path.isdir(run) and not os.listdir(run)):
            raise SystemExit(
                f"refusing to clear --out {run}: it exists, is non-empty, and was not "
                f"created by mmgclip_tpu_torch.tools.reproduce (no {MARKER} marker). "
                "Pick a fresh directory or delete it yourself.")
    os.makedirs(run, exist_ok=True)
    with open(marker, "w") as fh:
        fh.write("created by mmgclip_tpu_torch.tools.reproduce; safe to delete\n")


def report_from_store(cfg, device) -> tuple:
    """Decisions and the bug-compat report for the first stored feature file
    of the trained run -> (features path, decisions, text)."""
    tokenizer = Tokenizer.from_pretrained(cfg.tokenizer.config.tokenizer_name,
                                          sequence_length=int(cfg.tokenizer.config.sequence_length))
    model = MMGCLIP(cfg, seed=int(cfg.base.seed), vocab_size=tokenizer.vocab_size)
    ckp = os.path.join(cfg.checkpoints.checkpoints_export_dir, cfg.checkpoints.checkpoints_file_name)
    load_clip_params(model, load_checkpoint(ckp)["params"])
    model.to(device).eval()
    feats_dir = cfg.base.features_export_dir
    first = sorted(os.path.join(dp, f) for dp, _dn, fn in os.walk(feats_dir)
                   for f in fn if f.endswith(".npy"))[0]
    feats = torch.from_numpy(np.load(first).reshape(1, -1).astype(np.float32)).to(device)
    decisions = decide(model, tokenizer, feats)
    text, _ = generate_report(decisions, rng=seeding(int(cfg.base.seed)).host, bug_compat=True)
    return first, decisions, text


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--convnext", help="TorchScript/.pt ConvNeXt classifier")
    parser.add_argument("--bert", help="Local HF BERT snapshot dir")
    parser.add_argument("--base-data", help="base dataset root (reference layout)")
    parser.add_argument("--annotated-data", help="annotated dataset root")
    parser.add_argument("--lists-data", help="lists dir")
    parser.add_argument("--out", default=os.path.join(REPO, "outputs", "reproduce"))
    parser.add_argument("--config-name", default="train_binary_class_clf")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--fixtures", action="store_true",
                        help="synthesize torch artifacts + data tree and rehearse offline")
    parser.add_argument("--verify-convert", action="store_true",
                        help="run the converter's torch-oracle check")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    if not args.fixtures and not (args.convnext and args.bert):
        parser.error("--convnext and --bert are required (or use --fixtures)")
    return args


def main(argv: Optional[List[str]] = None) -> str:
    """The entry point; returns the run directory."""
    args = parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    run, seconds = reproduce(args, device)
    print("reproduce: seconds per step " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    print(f"reproduce: complete run under {run}")
    return run


def reproduce(args: argparse.Namespace, device,
              overrides: Sequence[str] = ()) -> Tuple[str, Dict[str, float]]:
    """The five steps for parsed ``args`` on ``device`` -> (run directory,
    seconds per step).  ``overrides``: ``key=value`` settings composed into
    the run config (a caller's batch sizes for a small tree)."""
    device_arg = ["--device", str(device)]
    seconds: Dict[str, float] = {}
    run = os.path.abspath(args.out)
    prepare_out(run)
    hf_config = None
    if args.fixtures:
        fixture_root = os.path.join(run, "artifacts")
        os.makedirs(fixture_root, exist_ok=True)
        args.convnext, args.bert, hf_config = make_torch_fixtures(fixture_root)
        base, annotated, lists_dir, _ = build_image_label_tree(
            os.path.join(run, "data"), n_benign=10, n_malignant=10,
            image_size=64, feature_store=False, pixel_class_signal=True,
        )
        args.base_data, args.annotated_data, args.lists_data = base, annotated, lists_dir

    # ---- 1+2: convert the torch artifacts to flax trees
    convnext_npz = os.path.join(run, "converted", "convnext_tiny_clf.npz")
    bert_msgpack = os.path.join(run, "converted", "bert.msgpack")
    t0 = time.perf_counter()
    print("== convert_convnext ==")
    convert_convnext.main(["--input", args.convnext, "--output", convnext_npz, *device_arg]
                          + (["--verify"] if args.verify_convert else []))
    seconds["convert_convnext"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== convert_bert ==")
    convert_bert.main(["--input", args.bert, "--output", bert_msgpack, *device_arg])
    seconds["convert_bert"] = time.perf_counter() - t0

    # ---- compose the run config around the converted weights
    cfg = compose(DEFAULT_CONFIG_DIR, args.config_name, overrides=list(overrides), run_dir=run)
    cfg.networks.image_encoder.convnext_tiny_clf_path = convnext_npz
    cfg.networks.text_encoder.weights_path = bert_msgpack
    if hf_config is not None:  # the fixture towers are tiny; mirror their shapes
        cfg.networks.text_encoder.config = Config(dict(hf_config))
        cfg.tokenizer.config.sequence_length = 32
        cfg.dataloader.train.batch_size = 4
        cfg.dataloader.valid.batch_size = 2
        cfg.dataloader.test.batch_size = 2
        cfg.scheduler.config.epochs = args.epochs or 2
    elif args.epochs:
        cfg.scheduler.config.epochs = args.epochs
    if args.base_data:
        cfg.dataset.config.base_dataset_path = args.base_data
    if args.annotated_data:
        cfg.dataset.config.annotated_dataset_path = args.annotated_data
    if args.lists_data:
        cfg.dataset.config.lists_dataset_path = args.lists_data
    cfg.base.features_export_dir = os.path.join(run, "encoded")
    cfg.base.export_dir = run
    cfg.base.results_export_dir = os.path.join(run, "results")
    cfg.base.tensorboard_export_dir = os.path.join(run, "runs")
    cfg.checkpoints.checkpoints_export_dir = os.path.join(run, "checkpoints")
    save_snapshot(cfg, run)

    # ---- 3: encode the dataset with the converted image tower
    t0 = time.perf_counter()
    print("== encode_images ==")
    encode_images.extract(cfg, device=device)
    seconds["encode_images"] = time.perf_counter() - t0

    # ---- 4: train (+ test() per config)
    t0 = time.perf_counter()
    print("== train ==")
    train.run(cfg, device=device)
    seconds["train"] = time.perf_counter() - t0

    # ---- 5: one generated report from the trained run
    t0 = time.perf_counter()
    print("== generate_report ==")
    first, decisions, text = report_from_store(cfg, device)
    with open(os.path.join(run, "generated_report.txt"), "w") as fh:
        fh.write(f"source features: {first}\ndecisions: {json.dumps(decisions)}\n\n{text}\n")
    seconds["generate_report"] = time.perf_counter() - t0
    print("report:", text)
    return run, seconds


if __name__ == "__main__":
    main()
