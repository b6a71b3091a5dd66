"""Training entry point (port of the root ``train.py``; reference:
train.py:1-93).

    python -m mmgclip_tpu_torch.train [--config-name train_binary_class_clf]
        [--device cpu] [key=value ...]

Composes the config (writing the run dir's ``.hydra`` snapshot), replays the
seeded train/val/test splits, trains the CLIP heads over the frozen towers
and, when ``dataset.eval.enum_classes`` is set and the eval dataset is the
training one, evaluates the test split.  ``--config-name
train_exam_reports_clf`` trains the exam-report family (``StudyReportDataset``;
its eval dataset differs, so there is no test split).  On the card the fused
epoch runs as a CUDA graph (``training/experiment.py``).
Runs on the CUDA card unless ``--device`` names another device; with no card
and no ``--device`` it raises before any work.  Under ``torchrun
--nproc_per_node=P -m mmgclip_tpu_torch.train ...`` each process joins the
process group from torchrun's environment (``parallel/multihost.py``: nccl
with a card per rank, gloo otherwise) and the trainer lays the ranks out as
the JAX trainer lays out devices; rank 0 writes the run.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from .cli import compose_run
from .data.datasets import get_dataset
from .data.loader import DataLoaders, dataloader_percentage
from .ingest.encode import resolve_device
from .parallel.mesh import process_index
from .parallel.multihost import torchrun_session
from .training.experiment import create_experiment
from .utils.logging import logger
from .utils.seeding import seeding


def run(cfg, device=None, init_params: Optional[Dict] = None):
    """Train (and test) one experiment; returns the experiment object.
    ``init_params``: a JAX-layout trainable tree to start from."""
    experiment = build_experiment(cfg, device=device, init_params=init_params)
    if cfg.get_path("base.resume", False):
        experiment.resume()
    experiment.run()
    return experiment


def build_experiment(cfg, device=None, init_params: Optional[Dict] = None):
    """The dataset, its seeded splits and loaders, and the experiment over
    them, before any training."""
    seeding(int(cfg.base.seed))

    dataset = get_dataset(cfg.dataset.name)(config=cfg)
    logger.info(f"Description Example: {dataset[0]['image_description']}")
    logger.info(f"Features Shape: {dataset[0]['image_features'].shape}")

    # split train/val, then (when eval uses the same dataset type) val/test
    train_split, val_split = dataset.random_split(dataset=dataset, split="train")
    logger.info(f"Train split len: ({len(train_split)}), Valid split len ({len(val_split)}).")
    test_split = None
    if cfg.dataset.name == cfg.dataset.eval.dataset.name:
        val_split, test_split = dataset.random_split(dataset=val_split, split="test")
        logger.info(f"Test split len ({len(test_split)}).")
    else:
        logger.info("Using different dataset for testing, not splitting validation.")

    def loader(split, section):
        return DataLoaders(config=cfg, dataset_split=split).get_dataloader(
            **cfg.dataloader[section], collate_fn=dataset.collate_fn)

    train_dataloader = loader(train_split, "train")
    val_dataloader = loader(val_split, "valid")
    test_dataloader = loader(test_split, "test") if test_split is not None else None

    if cfg.dataset.percentage.name != "100percent":
        logger.info(f"Using only {cfg.dataset.percentage.config.percentage} of training data.")
        train_dataloader = dataloader_percentage(train_dataloader, cfg, collate_fn=dataset.collate_fn)

    experiment_class = create_experiment(cfg.experiments.config.experiment_name)
    return experiment_class(
        config=cfg, train_dataloader=train_dataloader, valid_dataloader=val_dataloader,
        test_dataloader=test_dataloader, tokenizer=dataset.tokenizer, device=device,
        init_params=init_params,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    with torchrun_session(args.device) as joined:
        if joined and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        run(compose_run("train_binary_class_clf", rest, snapshot=process_index() == 0),
            device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
