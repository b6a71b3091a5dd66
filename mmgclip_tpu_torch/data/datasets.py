"""Datasets: image-level labels (port of mmgclip_tpu/data/datasets.py).

Rows are dicts, not DataFrames (the card's machine has no pandas); the row
order, the supervision text, the seeded prompt draws and the token ids are
those of the JAX package's ``ImageLabelDataset``
(reference: mmgclip/dataset/dataset.py:14-351):

* all text is generated AND tokenized once at construction;
* all feature vectors are loaded into one contiguous float32 array up front,
  so collate is pure numpy indexing;
* splits replay from the seed (see data.split).

``StudyReportDataset`` waits for ``data/reports.py`` and the
``encode_studies`` slice (ROADMAP.md); ``get_dataset`` raises for it.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional

import numpy as np

from ..config.registry import DATASETS
from ..prompts.generator import generate_gtr_prompt_sentence, generate_label_prompt_sentence
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists
from .ingest import create_dataset_df
from .labels import cast_label, prepare_prompt_labels
from .paths import create_dataset_path
from .split import random_split
from .store import load_features
from .tokenizer import Tokenizer


def _study_gtr_report(row, rng: random.Random) -> str:
    """Per-image gtr-style pseudo report (reference: dataset.py:198-236)."""
    prompts: List[str] = []
    if row["has_mass"]:
        malign = "malignant" if row["image_label"] == 1 else "benign"
        margins = sorted({str(v).lower() for v in row["mass_margin"] if v != -1})
        margin = margins[0] if margins else "unknown"
        shapes = sorted({str(v).lower() for v in row["mass_shape"] if v != -1})
        shape = shapes[0] if shapes else "unknown"
        prompts.append(
            generate_gtr_prompt_sentence(
                "gtr_mass:True", n=1, rng=rng, M_MALIG=malign, M_MARG=margin, M_SHAPE=shape
            )
        )
    if row["has_calc"]:
        malign = "malignant" if row["image_label"] == 1 else "benign"
        prompts.append(generate_gtr_prompt_sentence("gtr_calc:True", n=1, rng=rng, C_MALIG=malign))
    if row["has_architectural_distortion"]:
        prompts.append(
            generate_gtr_prompt_sentence("gtr_is_architectural_distortion:True", n=1, rng=rng)
        )
    return " ".join(prompts)


def _append_text_dump(path: str, texts: List[str]) -> None:
    """One value per line, space-separated CSV quoting (what the JAX
    package's ``Series.to_csv(sep=" ", header=False, index=False, mode="a")``
    writes)."""
    with open(path, "a", newline="") as fh:
        writer = csv.writer(fh, delimiter=" ", quoting=csv.QUOTE_MINIMAL, lineterminator="\n")
        for text in texts:
            writer.writerow([text])


@DATASETS.register("ImageLabelDataset")
class ImageLabelDataset:
    def __init__(self, config, data_folder: str = "0/02", split: Optional[str] = None):
        self.config = config
        self.split = split
        self.data_path = os.path.join(config.base.features_export_dir, data_folder)
        self._rng = random.Random(int(config.base.seed))

        gen_sentence = bool(config.dataset.config.generate_label_prompt_sentence)
        gen_report = bool(config.dataset.config.generate_label_prompt_report)
        self.search_col = (
            config.dataset.config.search_col if not (gen_sentence or gen_report) else "search_col"
        )
        self.new_col = self.search_col + "_new"

        # annotation rows + text column, in image_id order
        self.dataset_df = sorted(create_dataset_df(config), key=lambda r: r["image_id"])
        self._build_text_column(gen_sentence, gen_report)

        # feature store index, inner-joined on image_id in the annotation
        # rows' order (reference: dataset.py:52-59)
        store = {}
        for entry in sorted(create_dataset_path(self.data_path), key=lambda r: r["image_id"]):
            store.setdefault(entry["image_id"], []).append(entry["image_path"])
        keep = ["image_id", "image_label", "mass_shape", "mass_margin", "has_mass",
                "has_architectural_distortion", "has_calc", self.new_col]
        self.rows = [
            {"image_path": path, **{k: row[k] for k in keep}}
            for row in self.dataset_df
            for path in store.get(row["image_id"], [])
            if row["image_label"] != 2
        ]
        logger.info(f"Total dataset length: {len(self.rows)}.")

        export_dir = create_directory_if_not_exists(config.base.export_dir)
        _append_text_dump(os.path.join(export_dir, "image_description.txt"),
                          [row[self.new_col] for row in self.rows])

        # tokenizer + one-shot tokenization of the full text column
        self.tokenizer = Tokenizer.from_pretrained(
            config.tokenizer.config.tokenizer_name,
            sequence_length=int(config.tokenizer.config.sequence_length),
        )
        self.sequence_length = int(config.tokenizer.config.sequence_length)
        texts = [str(row[self.new_col]) for row in self.rows]
        self._tokens = self.tokenizer(texts, max_length=self.sequence_length) if texts else None

        # contiguous feature bank
        self._features = (
            np.stack([np.asarray(load_features(row["image_path"]), np.float32) for row in self.rows])
            if self.rows
            else np.zeros((0, 768), np.float32)
        )
        self._prompt_labels = [prepare_prompt_labels(row) for row in self.rows]

    # ------------------------------------------------------------------
    def _build_text_column(self, gen_sentence: bool, gen_report: bool) -> None:
        """Populate the supervision-text column (reference: dataset.py:90-244)."""
        rows = self.dataset_df
        if gen_report:
            for row in rows:
                row[self.new_col] = _study_gtr_report(row, self._rng)
            return
        if gen_sentence:
            template = self.config.dataset.template
            source_col = self.search_col if rows and self.search_col in rows[0] else "image_label"
            for row in rows:
                side = 0 if row[source_col] == 0 else 1
                row[self.new_col] = generate_label_prompt_sentence(
                    template.label[side], template.template_keys[side], n=1,
                    template=template.prompt_template or None, rng=self._rng,
                )[0]
            return
        enums_class = self.config.dataset.config.enums_class
        for row in rows:
            row[self.new_col] = cast_label(row[self.search_col], enums_class)

    # ------------------------------------------------------------------
    def random_split(self, dataset, split: str):
        ratio = (
            self.config.dataset.split.train_split_ratio
            if split == "train"
            else self.config.dataset.split.test_split_ratio
        )
        self.split = split
        return random_split(dataset, float(ratio), int(self.config.base.seed))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        return {
            "index": index,
            "image_features": self._features[index],
            "image_description": row[self.new_col],
            "image_label": np.asarray([row["image_label"]], np.int32),
            "image_id": row["image_id"],
            "prompt_labels": self._prompt_labels[index],
        }

    def collate_fn(self, instances: List[Dict]) -> Dict:
        idx = np.asarray([ins["index"] for ins in instances], np.int64)
        return {
            "indices": idx,
            "image_features": self._features[idx],
            "text_tokens": {k: v[idx] for k, v in self._tokens.items()},
            "image_description": [ins["image_description"] for ins in instances],
            "image_label": np.stack([ins["image_label"] for ins in instances]),
            "image_id": [ins["image_id"] for ins in instances],
            "prompt_labels": [ins["prompt_labels"] for ins in instances],
        }


class StudyReportDataset:
    """Exam-level reports: not ported yet (ROADMAP.md)."""

    def __init__(self, config, split: Optional[str] = None):
        raise NotImplementedError(
            "StudyReportDataset waits for data/reports.py (map_path_to_features) and the "
            "encode_studies slice of the port (ROADMAP.md, queue 1 item 5)")


DATASETS.add("StudyReportDataset", StudyReportDataset)


def get_dataset(dataset_name: str):
    """Name -> dataset class (reference: dataset.py:563-585)."""
    logger.info(f"Using {dataset_name} dataset.")
    return DATASETS.get(dataset_name)
