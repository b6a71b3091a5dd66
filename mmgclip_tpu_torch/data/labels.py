"""Label casting: dataset-row values -> class-name strings (port of
mmgclip_tpu/data/labels.py).

One shared implementation of the per-enum casting rules the reference
duplicates in two places (reference: mmgclip/dataset/dataset.py:123-191 and
:249-331): first-mass-value selection, the -1 -> "unknown" rule, the
lobular -> oval fold, and the human-readable spellings of the boolean
vocabularies.
"""

from __future__ import annotations

from typing import Dict

from ..prompts.enums import (
    BenignMalignantDatasetLabels,
    HasArchDistortion,
    HasCalcification,
    HasMassLabels,
    MassMarginLabels,
    MassShapeLabels,
    get_key_from_value,
)

_SPELLINGS = {
    "nomass": "no mass",
    "noarchitecturaldistortion": "no architectural distortion",
    "displayedarchitecturaldistortion": "displayed architectural distortion",
    "noncalcified": "non-calcified",
    "hascalcification": "has calcification",
}


def cast_label(value, enums_class: str) -> str:
    """Cast one raw dataframe value to its class-name string."""
    if enums_class == "BenignMalignantDatasetLabels":
        return (
            BenignMalignantDatasetLabels(0).name
            if value == BenignMalignantDatasetLabels(0).value
            else BenignMalignantDatasetLabels(1).name
        )

    if enums_class == "MassShapeLabels":
        label = str(value[0])  # first shape, whether one or many
        if label == "-1":
            label = MassShapeLabels(0).name
        elif label.lower() == "lobular":
            label = MassShapeLabels.oval.name
        return label.lower()

    if enums_class == "MassMarginLabels":
        label = str(value[0])  # first margin
        if label == "-1":
            label = MassMarginLabels(0).name
        return label.lower()

    if enums_class == "HasMassLabels":
        label = get_key_from_value(HasMassLabels, 1 if value else 0)
        return _SPELLINGS.get(label, label).lower()

    if enums_class == "HasArchDistortion":
        label = get_key_from_value(HasArchDistortion, 1 if value else 0)
        return _SPELLINGS.get(label, label).lower()

    if enums_class == "HasCalcification":
        label = get_key_from_value(HasCalcification, 1 if value else 0)
        return _SPELLINGS.get(label, label).lower()

    raise ValueError(f"Unknown enums_class {enums_class!r}")


def prepare_prompt_labels(row) -> Dict[str, str]:
    """All six label families for one image row
    (reference: dataset.py:249-331)."""
    return {
        "HasMassLabels": cast_label(row["has_mass"], "HasMassLabels"),
        "MassShapeLabels": cast_label(row["mass_shape"], "MassShapeLabels"),
        "MassMarginLabels": cast_label(row["mass_margin"], "MassMarginLabels"),
        "BenignMalignantDatasetLabels": cast_label(row["image_label"], "BenignMalignantDatasetLabels"),
        "HasArchDistortion": cast_label(row["has_architectural_distortion"], "HasArchDistortion"),
        "HasCalcification": cast_label(row["has_calc"], "HasCalcification"),
    }


def process_class_list(class_list: list) -> list:
    """Training-label <-> inference-label spelling normalization
    (reference: data_utils.py:921-962)."""
    if not isinstance(class_list, list):
        raise ValueError("`class_list` has to be a list of classes.")
    replacements = {
        "illdefined": "ill defined",
        "nomass": "no mass",
        "noncalcified": "non-calcified",
        "hascalcification": "has calcification",
        "noarchitecturaldistortion": "no architectural distortion",
        "displayedarchitecturaldistortion": "displayed architectural distortion",
    }
    return [replacements.get(item, item) for item in class_list]
