"""Supervised ConvNeXt-classifier baseline evaluation (port of the root
``evaluate_cnn.py``; reference: evaluate_cnn.py:1-47).

    python -m mmgclip_tpu_torch.evaluate_cnn [--config-name evaluate_cnn_clf]
        [--device cpu] [key=value ...]

Evaluates the tower's binary classifier head (LN with two-pass variance,
eps 1e-6, then a dense layer) over the stored pooled features of the same seeded test split the
CLIP runs use, one-vs-all ROC per class, for the supervised-vs-zero-shot
comparison.  Runs on the CUDA card unless ``--device`` names another device;
with no card and no ``--device`` it raises before any work.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from .cli import compose_run
from .data.datasets import get_dataset
from .data.loader import DataLoaders
from .evaluation.evaluator import Evaluator
from .ingest.encode import load_convnext_tower, resolve_device
from .models._params import layer_norm
from .utils.logging import logger
from .utils.seeding import seeding
from .utils.table import Table


def run(cfg, device=None) -> Table:
    device = resolve_device(device)
    seeding(int(cfg.base.seed))
    dataset = get_dataset(cfg.dataset.eval.dataset.name)(config=cfg)
    logger.info(f"Description Example: {dataset[0]['image_description']}")

    _, val_split = dataset.random_split(dataset=dataset, split="train")
    _, test_split = dataset.random_split(dataset=val_split, split="test")
    logger.info(f"Test split len ({len(test_split)})")
    test_dataloader = DataLoaders(config=cfg, dataset_split=test_split).get_dataloader(
        **cfg.dataloader.test, collate_fn=dataset.collate_fn)

    # the classifier head over stored pooled features (reference: evaluator.py:676-688)
    module, _cn_config = load_convnext_tower(cfg, device=device)
    norm, fc = module.head_norm, module.head_fc

    def classifier_fn(pooled: torch.Tensor) -> torch.Tensor:
        return layer_norm(pooled, norm.scale, norm.bias, 1e-6) @ fc.kernel + fc.bias

    results = Evaluator(config=cfg, test_dataloader=test_dataloader, tokenizer=dataset.tokenizer,
                        device=device, cnn_eval=True).evaluate_cnn(classifier_fn)
    logger.info(f"Results:\n{results}")
    return results


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    run(compose_run("evaluate_cnn_clf", rest, snapshot=False), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
