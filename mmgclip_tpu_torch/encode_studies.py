"""Study feature extraction + final dataset export (port of the root
``encode_studies.py``; reference: encode_studies.py:1-33).

    python -m mmgclip_tpu_torch.encode_studies [--config-name train_exam_reports_clf]
        [--device cpu] [key=value ...]
    torchrun --nproc_per_node=N -m mmgclip_tpu_torch.encode_studies [key=value ...]

Reads the post-translation CSV (latin1), with ``extract_features=true``
encodes every study's views through ``StudyFeatureExtractor`` into
``base.features_export_dir``, then points each study at its stored vector
and writes ``data/<post_translation_fileid>/final_reports_dataset.csv``
under the working directory.  Runs on every visible card unless
``--device`` names one device; with no card and no ``--device`` it raises
before any work.  Under torchrun each rank encodes its share of the
studies on its own card; after a barrier rank 0 alone writes the table.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from .cli import compose_run
from .data.csv_table import Table, read_csv
from .data.reports import map_path_to_features
from .ingest.encode import StudyFeatureExtractor, resolve_device
from .parallel.mesh import process_index, world_size
from .parallel.multihost import process_sum, torchrun_session
from .utils.logging import logger
from .utils.seeding import seeding


def extract(cfg, device=None) -> Tuple[Optional[Table], Optional[StudyFeatureExtractor]]:
    """-> (the final table, None on ranks other than 0; the extractor when
    ``extract_features`` ran: its ``timings`` split the encode into decode,
    device and write seconds)."""
    seeding(int(cfg.base.seed))

    path = cfg.dataset.config.post_translation_dataset_path
    logger.info(f"Loading {path} file...")
    postprocessed = read_csv(path, encoding="latin1", index_col=0)

    extractor = None
    if getattr(cfg, "extract_features", False):
        extractor = StudyFeatureExtractor(config=cfg, dataset=postprocessed.rows, device=device)
        total = process_sum(extractor.extract())
        if process_index() == 0:
            logger.info(f"Stored {total} study vectors over {world_size()} process(es).")
    if world_size() > 1:
        import torch.distributed as dist

        dist.barrier()  # every rank's vectors are on disk before the table looks for them
        if process_index() != 0:
            return None, extractor

    processed = map_path_to_features(
        postprocessed, cfg, export=True,
        export_dir=f"data/{cfg.dataset.config.post_translation_fileid}/")
    logger.info(f"Final dataset shape: {(len(processed), len(processed.columns))}")
    return processed, extractor


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    resolve_device(args.device)  # no card and no --device: raise before any work
    with torchrun_session(args.device):
        extract(compose_run("train_exam_reports_clf", rest, snapshot=False), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
