"""Offline image feature extraction (port of the root ``encode_images.py``;
reference: encode_images.py:1-23).

    python -m mmgclip_tpu_torch.encode_images [--config-name train_binary_class_clf]
        [--device cpu] [key=value ...]

Composes the config, builds the dataset rows and writes the ``.npy`` feature
store under ``base.features_export_dir``.  Runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .cli import compose_run
from .data.ingest import create_dataset_df
from .ingest.encode import ImageFeatureExtractor, resolve_device
from .utils.logging import logger
from .utils.seeding import seeding


def extract(cfg, device=None) -> int:
    seeding(int(cfg.base.seed))
    rows = create_dataset_df(config=cfg)
    logger.info(f"Encoding {len(rows)} annotated images.")
    return ImageFeatureExtractor(config=cfg, dataset=rows, device=device).extract()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work
    extract(compose_run("train_binary_class_clf", rest), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
