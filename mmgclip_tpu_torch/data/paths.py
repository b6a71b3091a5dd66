"""ID/path scheme and feature-store walking (port of mmgclip_tpu/data/paths.py).

The dataset uses IDs of the form ``p{8-digit patient}{2-digit study}{view}``
with view in {cl, cr, ml, mr}, laid out as
``<base>/<pid[0:2]>/<pid>/st<study>/<image_id>.png``
(reference: mmgclip/utils/data_utils.py:32-73,146-173).  Tables are plain
lists of row dicts, not DataFrames.
"""

from __future__ import annotations

import difflib
import os
from pathlib import Path
from typing import Dict, List, Union

FEATURE_SUFFIXES = (".npy", ".pth")


def get_project_root() -> Path:
    return Path(__file__).parent.parent


def find_similar_item(search_text: str, items: List[str]) -> str:
    """Closest string match (replaces the reference's fuzzywuzzy dependency)."""
    scored = [(difflib.SequenceMatcher(None, search_text.lower(), item.lower()).ratio(), item)
              for item in items]
    return max(scored)[1]


def create_path(image_id: str, base_dataset_path: str) -> Union[str, List[str]]:
    """image id -> PNG path; patient id -> all view paths
    (reference: data_utils.py:32-60)."""
    if isinstance(image_id, str) and image_id[0] == "p":
        return os.path.join(base_dataset_path, image_id[1:3], image_id[1:9],
                            f"st{image_id[9:11]}", f"{image_id}.png")
    if isinstance(image_id, str) and len(image_id) == 8:
        studies_path = os.path.join(base_dataset_path, image_id[0:2], image_id)
        views = []
        for study in sorted(os.listdir(studies_path)):
            study_path = os.path.join(studies_path, study)
            for view in sorted(os.listdir(study_path)):
                views.append(os.path.join(study_path, view))
        return views
    raise ValueError(f"Unrecognized id format: {image_id!r}")


def create_exam_path(exam_id: str, base_dataset_path: str) -> str:
    """exam id (pid+study digits) -> study dir (reference: data_utils.py:62-73)."""
    return os.path.join(base_dataset_path, exam_id[0:2], exam_id[0:8], f"st{exam_id[8:10]}")


def validate_file_type(filepath: str, filetype: str = ".npy") -> bool:
    return filepath.lower().endswith(filetype)


def create_dataset_path(path: str) -> List[Dict[str, str]]:
    """Walk a feature store -> rows ``{"image_id", "image_path"}`` in the JAX
    package's order (reference: data_utils.py:146-173); .npy and .pth files."""
    rows = []
    for root, _dirs, files in os.walk(path):
        for name in sorted(files):
            filepath = os.path.join(root, name)
            for suffix in FEATURE_SUFFIXES:
                if validate_file_type(filepath, suffix):
                    rows.append({"image_id": name[: -len(suffix)], "image_path": filepath})
                    break
    return rows
