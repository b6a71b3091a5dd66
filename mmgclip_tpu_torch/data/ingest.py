"""JSON annotation -> dataset rows (port of mmgclip_tpu/data/ingest.py).

Walks the per-class annotation folders, keeps patients listed in the
normal/malignant list files, aggregates per-region labels and emits one row
per image view (reference: mmgclip/utils/data_utils.py:175-293).  Rows are
dicts keyed by ``COLUMNS``, in the JAX DataFrame's row order.

Label policy (reference: data_utils.py:257-264): benign folders -> 0;
malignant folders -> 1 when any region is malignant else 2 ("uncertain").
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List

from .paths import create_path, find_similar_item

COLUMNS = [
    "image_id",
    "image_label",
    "mass_margin",
    "mass_shape",
    "has_mass",
    "has_architectural_distortion",
    "has_calc",
    "image_path",
]


def _region_labels(regions: dict):
    margins: List = []
    shapes: List = []
    is_malig: List = []
    has_mass: List = []
    arch: List = []
    calc: List = []
    for _key, region in regions.items():
        props = region.get("properties", {})
        has_mass.append(region.get("is_mass", False))
        is_malig.append(region.get("is_malign", False))
        arch.append(region.get("is_architectural_distortion", False))
        calc.append(region.get("is_calcification_cluster", False)
                    or region.get("is_individual_calcification", False))
        margins.append(props.get("mass_margin", -1))
        shapes.append(props.get("mass_shape", -1))
    return margins, shapes, any(is_malig), any(has_mass), any(arch), any(calc)


def read_patient_list(path: str) -> set:
    """The ``patient_id`` column of a space-separated list file with a header
    (every value a string)."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh, delimiter=" ")
        header = next(reader)
        column = header.index("patient_id")
        return {row[column] for row in reader if row}


def create_dataset_df(config) -> List[Dict]:
    """Build the image-view annotation rows (reference: data_utils.py:175-293)."""
    dataset_path = config.dataset.config.annotated_dataset_path
    lists_path = config.dataset.config.lists_dataset_path
    base_path = config.dataset.config.base_dataset_path

    list_files = [f for f in os.listdir(lists_path) if f.endswith(".txt")]
    rows = []
    for folder in sorted(os.listdir(dataset_path)):
        folder_path = os.path.join(dataset_path, folder)
        if not os.path.isdir(folder_path):
            continue
        is_benign = "benign" in folder_path
        list_file = find_similar_item("normal" if is_benign else "malignant", list_files)
        valid_patients = read_patient_list(os.path.join(lists_path, list_file))

        for file in sorted(os.listdir(folder_path)):
            if not file.endswith(".json"):
                continue
            image_id = file[: -len(".json")]
            if image_id[1:9] not in valid_patients:
                continue
            with open(os.path.join(folder_path, file)) as fh:
                annotation = json.load(fh)
            regions = annotation[f"{image_id}_png"]["regions"]
            if regions:
                margins, shapes, is_malig, has_mass, arch, calc = _region_labels(regions)
            else:
                margins, shapes, is_malig, has_mass, arch, calc = [-1], [-1], False, False, False, False
            label = 0 if is_benign else (1 if is_malig else 2)
            view_path = create_path(image_id, base_dataset_path=base_path)
            if os.path.isfile(view_path):
                rows.append(dict(zip(COLUMNS, [image_id, label, margins, shapes, has_mass,
                                               arch, calc, view_path])))
    return rows
