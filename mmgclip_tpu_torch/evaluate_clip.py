"""Zero-shot evaluation of a past experiment (port of the root
``evaluate_clip.py``; reference: evaluate_clip.py:1-75).

    python -m mmgclip_tpu_torch.evaluate_clip --experiment_path yyyy-mm-dd/XX-XX-XX
        --run_name results_v2 [--device cpu]

Re-reads the run's ``.hydra`` snapshot, replays the seeded test split and
runs the Evaluator against the stored checkpoint, writing ``results.txt``
and ``results.json`` under ``<run>/<run_name>``.  Runs on the CUDA card
unless ``--device`` names another device; with no card and no ``--device``
it raises before any work.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import recompose
from .data.datasets import get_dataset
from .data.loader import DataLoaders
from .evaluation.evaluator import Evaluator
from .ingest.encode import resolve_device
from .utils.logging import logger
from .utils.seeding import seeding


def evaluate(experiment_path: str, run_name: str, device=None) -> List:
    # the reference's relative form ('yyyy-mm-dd/XX-XX-XX' inside outputs/)
    # or an absolute run directory; every export path derives from it
    if not os.path.isabs(experiment_path):
        experiment_path = os.path.join("outputs", experiment_path)
    if not os.path.isdir(experiment_path) or "checkpoints" not in os.listdir(experiment_path):
        raise ValueError(
            "Wrong value for `experiment_path`. Pass the folder inside outputs/ "
            "('yyyy-mm-dd/XX-XX-XX', without the leading 'outputs/') or an "
            "absolute run directory.")
    cfg = recompose(experiment_path)
    cfg.base.export_dir = experiment_path
    cfg.base.features_export_dir = cfg.get_path("base.features_export_dir", "outputs/dataset")
    cfg.base.results_export_dir = os.path.join(experiment_path, run_name)
    cfg.checkpoints.checkpoints_export_dir = os.path.join(experiment_path, "checkpoints")

    seeding(int(cfg.base.seed))
    dataset = get_dataset(cfg.dataset.eval.dataset.name)(config=cfg)
    logger.info(f"Description Example: {dataset[0]['image_description']}")

    _, val_split = dataset.random_split(dataset=dataset, split="train")
    _, test_split = dataset.random_split(dataset=val_split, split="test")
    logger.info(f"Test split len ({len(test_split)})")
    test_dataloader = DataLoaders(config=cfg, dataset_split=test_split).get_dataloader(
        **cfg.dataloader.test, collate_fn=dataset.collate_fn)
    evaluator = Evaluator(config=cfg, test_dataloader=test_dataloader,
                          tokenizer=dataset.tokenizer, device=device)
    return evaluator.evaluate_experiment()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True,
                        help="Run folder inside outputs/, e.g. 'yyyy-mm-dd/XX-XX-XX'.")
    parser.add_argument(
        "--train_split",
        type=lambda s: s.strip().lower() not in ("false", "0", "no", ""), default=True,
        help="Replay the training-time split (only True is supported).")
    parser.add_argument("--run_name", type=str, required=True,
                        help="Folder name for the new results inside the experiment dir.")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    assert args.train_split, "Only train_split=True is supported."
    evaluate(args.experiment_path, args.run_name, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
