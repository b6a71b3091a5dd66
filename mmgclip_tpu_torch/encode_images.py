"""Offline image feature extraction (port of the root ``encode_images.py``;
reference: encode_images.py:1-23).

    python -m mmgclip_tpu_torch.encode_images [--config-name train_binary_class_clf]
        [--device cpu] [key=value ...]
    torchrun --nproc_per_node=N -m mmgclip_tpu_torch.encode_images [key=value ...]

Composes the config, builds the dataset rows and writes the ``.npy`` feature
store under ``base.features_export_dir``.  Runs on every visible card (each
batch split over them; ``CUDA_VISIBLE_DEVICES`` picks them) unless
``--device`` names one device; with no card and no ``--device`` it raises
before any work.  Under torchrun each rank encodes its share of the images
on its own card (``cuda:LOCAL_RANK``) and rank 0 logs the total.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .cli import compose_run
from .data.ingest import create_dataset_df
from .ingest.encode import ImageFeatureExtractor, resolve_device
from .parallel.mesh import process_index, world_size
from .parallel.multihost import process_sum, torchrun_session
from .utils.logging import logger
from .utils.seeding import seeding


def extract(cfg, device=None) -> int:
    """Encode this process's share of the images; -> the count it stored."""
    seeding(int(cfg.base.seed))
    rows = create_dataset_df(config=cfg)
    logger.info(f"Encoding {len(rows)} annotated images.")
    count = ImageFeatureExtractor(config=cfg, dataset=rows, device=device).extract()
    total = process_sum(count)
    if process_index() == 0:
        logger.info(f"Stored {total} images over {world_size()} process(es).")
    return count


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    resolve_device(args.device)  # no card and no --device: raise before any work
    with torchrun_session(args.device):
        extract(compose_run("train_binary_class_clf", rest, snapshot=process_index() == 0),
                device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
