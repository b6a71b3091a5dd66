"""Label vocabularies for BI-RADS attribute classification.

Mirrors the reference vocabularies (reference: mmgclip/prompts/enums.py:13-97)
so that config files, eval enum lists, and checkpoint metadata stay
interchangeable between the two frameworks.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict


class HasArchDistortion(Enum):
    noarchitecturaldistortion = 0
    displayedarchitecturaldistortion = 1


class BenignMalignantDatasetLabels(Enum):
    benign = 0
    malignant = 1


class HasMassLabels(Enum):
    nomass = 0
    mass = 1


class HasCalcification(Enum):
    negative = 0
    hascalcification = 1


class MassShapeLabels(Enum):
    unknown = 0
    oval = 1  # lobular is folded into oval at label-casting time
    round = 2
    irregular = 3


class MassMarginLabels(Enum):
    unknown = 0
    circumscribed = 1
    obscured = 2
    spiculated = 3
    illdefined = 4


# Ground-truth-region (gtr) annotation-file vocabularies
# (reference: mmgclip/prompts/enums.py:47-59).
class gtr_Malign(Enum):
    malignant = True


class gtr_Mass(Enum):
    mass = True


class gtr_MassMargin(Enum):
    circumscribed = 1
    illdefined = 2
    spiculated = 3
    obscured = 4


# Histology code -> clinical name (reference: mmgclip/prompts/enums.py:61-90).
gtr_Histology: Dict[int, str] = {
    1: "ductal carcinoma in situ (DCIS)",
    2: "invasive ductal carcinoma (IDC)",
    3: "lobular carcinoma in situ (LCIS)",
    4: "invasive lobular carcinoma (ILC)",
    5: "papilloma in situ",
    6: "infiltrative papilloma, intracystic carcinoma",
    7: "medullar carcinoma",
    8: "adenoid-cystic carcinoma",
    9: "mucinous/colloid carcinoma",
    10: "tubular carcinoma",
    11: "plaveiselcel carcinoma",
    12: "M. Paget",
    13: "sarcoma",
    14: "Non Hodgkin lymphoma",
    15: "metastasis from elsewhere",
    20: "fibroadenoma",
    21: "solitary cyst",
    22: "radial scar, complex sclerosing lesion",
    23: "phyllodes tumor",
    24: "single papilloma",
    25: "multiple intraductal papillomatosis",
    26: "fibrocystic change",
    29: "atypical ductal hyperplasia",
    30: "normal tissue",
    99: "invasive carcinoma",
}

#: All enum vocabularies addressable by name from configs
#: (``dataset.eval.enum_classes``) without a ``globals()`` lookup.
ENUM_CLASSES: Dict[str, type] = {
    "HasArchDistortion": HasArchDistortion,
    "BenignMalignantDatasetLabels": BenignMalignantDatasetLabels,
    "HasMassLabels": HasMassLabels,
    "HasCalcification": HasCalcification,
    "MassShapeLabels": MassShapeLabels,
    "MassMarginLabels": MassMarginLabels,
    "gtr_Malign": gtr_Malign,
    "gtr_Mass": gtr_Mass,
    "gtr_MassMargin": gtr_MassMargin,
}


def get_enum_class(name: str) -> type:
    if name not in ENUM_CLASSES:
        raise ValueError(f"Unknown enum class {name!r}. Available: {sorted(ENUM_CLASSES)}")
    return ENUM_CLASSES[name]


def get_key_from_value(enum_class: type, value) -> str:
    """Reverse lookup with an "unknown" fallback (reference: enums.py:92-97)."""
    for key, member in enum_class.__members__.items():
        if member.value == value:
            return key
    return "unknown"
