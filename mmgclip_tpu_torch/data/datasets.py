"""Datasets: image-level labels and exam-level reports (port of
mmgclip_tpu/data/datasets.py).

Rows are dicts, not DataFrames (the card's machine has no pandas); the row
order, the supervision text, the seeded prompt draws and the token ids are
those of the JAX package's ``ImageLabelDataset`` and ``StudyReportDataset``
(reference: mmgclip/dataset/dataset.py:14-351, :353-561):

* all text is generated AND tokenized once at construction;
* all feature vectors are loaded into one contiguous float32 array up front,
  so collate is pure numpy indexing;
* splits replay from the seed (see data.split).
"""

from __future__ import annotations

import ast
import os
import random
from typing import Dict, List, Optional

import numpy as np

from ..config.registry import DATASETS
from ..prompts.enums import MassShapeLabels, get_key_from_value, gtr_MassMargin
from ..prompts.generator import generate_gtr_prompt_sentence, generate_label_prompt_sentence
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists
from .csv_table import append_text_column, read_csv
from .ingest import create_dataset_df
from .labels import cast_label, prepare_prompt_labels, process_class_list
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
        append_text_column(os.path.join(export_dir, "image_description.txt"),
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


@DATASETS.register("StudyReportDataset")
class StudyReportDataset:
    def __init__(self, config, split: Optional[str] = None):
        self.config = config
        self.split = split
        self._rng = random.Random(int(config.base.seed))

        self.final_reports_dataset = read_csv(config.dataset.config.final_reports_dataset_path,
                                              encoding="unicode_escape", index_col=0)
        # empty report cells read as missing: they become "" (the JAX
        # package's fillna), so they neither poison the prompt concat nor
        # tokenize as the text 'nan'
        table = self.final_reports_dataset
        for col in ("image_description", "image_impression"):
            if col in table.columns:
                table.set_column(col, ["" if v is None else v for v in table.column(col)])
        logger.info(f"Total dataset length: {len(table)}.")

        if config.dataset.config.gtr_prompt_generation:
            self._generate_gtr_prompts()

        self.rows = self.final_reports_dataset.rows
        export_dir = create_directory_if_not_exists(config.base.export_dir)
        append_text_column(os.path.join(export_dir, "image_description.txt"),
                          [row["image_description"] for row in self.rows])

        self.tokenizer = Tokenizer.from_pretrained(
            config.tokenizer.config.tokenizer_name,
            sequence_length=int(config.tokenizer.config.sequence_length),
        )
        self.sequence_length = int(config.tokenizer.config.sequence_length)
        self._tokens = self.tokenizer([str(row["image_description"]) for row in self.rows],
                                      max_length=self.sequence_length)
        self._impression_tokens = self.tokenizer(
            [str(row["image_impression"]) for row in self.rows],
            max_length=self.sequence_length)
        self._features = (
            np.stack([np.asarray(load_features(row["study_path"]), np.float32) for row in self.rows])
            if self.rows
            else np.zeros((0, 768), np.float32)
        )
        self._prompt_labels = [self._prepare_prompt_labels(row) for row in self.rows]

    # ------------------------------------------------------------------
    def _generate_gtr_prompts(self) -> None:
        """Mix generated prompts with/instead of translated reports
        (reference: dataset.py:380-497), drawing from one seeded stream row
        by row in the JAX package's order."""
        cfg = self.config.dataset.config
        bug_compat = bool(cfg.get("gtr_bug_compat", True))
        gtr_first: Dict[str, Dict] = {}  # first occurrence wins, as `.iloc[0]`
        for g_row in read_csv(cfg.gt_path).rows:
            gtr_first.setdefault(g_row["gtr_path"].split("/")[-1][:10], g_row)
        table = self.final_reports_dataset

        def study_key(row) -> str:
            return f"{row['patient_id']}{row['study_id'][2:]}"

        def with_birads(prompt: str, birads: str) -> str:
            if birads.lower() == "unknown":
                return prompt
            return prompt[:-1] + ", " + generate_gtr_prompt_sentence(
                "row.labels['birads']:True", n=1, rng=self._rng, B_SCORE=birads)

        def build(row) -> str:
            if not row["has_gtr_label"]:
                return generate_gtr_prompt_sentence("no_gtr", n=1, rng=self._rng)
            prompts: List[str] = []
            labels = ast.literal_eval(row["labels"])
            sample = gtr_first[study_key(row)]
            birads = str(labels.get("birads", "unknown"))
            if str(sample["gtr_mass"]) == "True":
                malign = "malignant" if str(sample["gtr_malign"]) == "True" else "benign"
                margin = get_key_from_value(gtr_MassMargin, int(sample["gtr_mass_margin"]))
                margin = process_class_list([margin])[0]
                prompts.append(with_birads(generate_gtr_prompt_sentence(
                    "gtr_mass:True", n=1, rng=self._rng, M_MALIG=malign, M_MARG=margin,
                    M_SHAPE=labels["masses"]["shapes"]), birads))
            if str(sample["gtr_calc"]) == "True":
                prompts.append(with_birads(generate_gtr_prompt_sentence(
                    "gtr_calc:True", n=1, rng=self._rng, C_MALIG="malignant",
                    C_DIST=labels["calcifications"]["distribution"]), birads))
            # quirk gtr_bug_compat: the reference checks `str(...) == True`,
            # which never holds, so it never emits (nor draws for) this prompt
            # (reference: dataset.py:455-456)
            if not bug_compat and str(sample["gtr_is_architectural_distortion"]) == "True":
                prompts.append(generate_gtr_prompt_sentence(
                    "gtr_is_architectural_distortion:True", n=1, rng=self._rng))
            return " ".join(prompts)

        table.set_column("has_gtr_label", [study_key(row) in gtr_first for row in table.rows])
        table.set_column("prompt_generated", [build(row) for row in table.rows])
        if cfg.use_gtr_prompts_only:
            table.set_column("image_description", table.column("prompt_generated"))
            self.final_reports_dataset = table.select(
                text != "" for text in table.column("image_description")).reset_index()
        else:
            table.set_column("image_description", [
                row["prompt_generated"] + " " + row["image_description"] for row in table.rows])

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

    @staticmethod
    def _prepare_prompt_labels(row) -> Dict:
        labels = ast.literal_eval(row["labels"])
        labels["BenignMalignantDatasetLabels"] = int(row["is_malig"])
        labels["MassShapeLabels"] = MassShapeLabels[labels["masses"]["shapes"]].value
        labels["BIRADS"] = labels["birads"]
        return labels

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        return {
            "index": index,
            "image_features": self._features[index],
            "image_description": row["image_description"],
            "image_impression": row["image_impression"],
            "image_label": np.asarray([int(row["is_malig"])], np.int32),
            "image_id": row["patient_id"],
            "prompt_labels": self._prompt_labels[index],
        }

    def collate_fn(self, instances: List[Dict]) -> Dict:
        idx = np.asarray([ins["index"] for ins in instances], np.int64)
        return {
            "indices": idx,
            "image_features": self._features[idx],
            "text_tokens": {k: v[idx] for k, v in self._tokens.items()},
            "image_impression_tokens": {k: v[idx] for k, v in self._impression_tokens.items()},
            "image_description": [ins["image_description"] for ins in instances],
            "image_label": np.stack([ins["image_label"] for ins in instances]),
            "image_id": [ins["image_id"] for ins in instances],
            "prompt_labels": [ins["prompt_labels"] for ins in instances],
        }


def get_dataset(dataset_name: str):
    """Name -> dataset class (reference: dataset.py:563-585)."""
    logger.info(f"Using {dataset_name} dataset.")
    return DATASETS.get(dataset_name)
