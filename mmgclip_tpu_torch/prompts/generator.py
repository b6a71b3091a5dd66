"""Prompt-sentence generation with explicit, seedable randomness (port of
mmgclip_tpu/prompts/generator.py; the banks are read with yaml_lite).

Re-implements the reference text-supervision generator
(reference: mmgclip/prompts/generator.py:97-393) on top of the YAML template
banks in ``banks.yaml``.  Differences from the reference are deliberate:

* every function threads an explicit ``rng`` (``random.Random``) so that
  generated training text and generated reports are reproducible — the parity
  gate requires deterministic report generation;
* the template banks live in a data file, not code;
* the slot-filling/elision rules are implemented per prompt (the reference
  mutates a shared replacement string across loop iterations, which only
  behaves correctly for ``n=1`` — the only n it ever uses).
"""

from __future__ import annotations

import os
import random
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Union

from ..config.yaml_lite import load_file

_BANKS_PATH = os.path.join(os.path.dirname(__file__), "banks.yaml")


@lru_cache(maxsize=1)
def _banks() -> Dict:
    return load_file(_BANKS_PATH)


def report_bank(key: str) -> List[str]:
    return list(_banks()["report"][key])


def template_bank(name: str) -> Dict[str, List[str]]:
    """Label-sentence banks by template name (BENIGN_MALIG / HAS_MASS / ...)."""
    mapping = {
        "BENIGN_MALIG": "benign_malig",
        "HAS_MASS": "has_mass",
        "MASS_SHAPE": "mass_shape",
        "MASS_MARGIN": "mass_margin",
    }
    return _banks()[mapping.get(name, "has_mass")]


def available_prompts_templates() -> Dict[str, Dict[str, List[str]]]:
    return {name: template_bank(name) for name in ("BENIGN_MALIG", "HAS_MASS", "MASS_SHAPE", "MASS_MARGIN")}


_DEFAULT_RNG = random.Random(0)


def seed_prompt_rng(seed: int) -> random.Random:
    """Reseed the module-default prompt RNG; returns it for convenience."""
    global _DEFAULT_RNG
    _DEFAULT_RNG = random.Random(seed)
    return _DEFAULT_RNG


def _rng(rng: Optional[random.Random]) -> random.Random:
    return rng if rng is not None else _DEFAULT_RNG


def _fill_mass_slots(prompt: str, m_marg: str, m_shape: str, m_malig: str) -> str:
    """Slot-fill one mass template with "unknown"-elision rules.

    Rules (reference: generator.py:231-252): an unknown margin drops the
    margin slot, an unknown shape drops the shape slot (with the "and"
    connective only when a margin is present), and when both are unknown the
    sentence is truncated to its final clause and capitalised.
    """
    if m_marg == "unknown" and m_shape == "unknown":
        return prompt.split(", ")[-1].replace("{M_MALIG}", m_malig).capitalize()
    replacement = "{M_MARG} {M_SHAPE}"
    if m_marg == "unknown":
        replacement = replacement.replace("{M_MARG} ", "")
    else:
        replacement = replacement.replace("{M_MARG}", f"{m_marg} margins")
    if m_shape == "unknown":
        replacement = replacement.replace(" {M_SHAPE}", "")
    else:
        shape_text = f"and {m_shape} shape" if m_marg != "unknown" else f"{m_shape} shape"
        replacement = replacement.replace("{M_SHAPE}", shape_text)
    return prompt.replace("{M_MALIG}", m_malig).replace("{M_MARG} {M_SHAPE}", replacement)


def _fill_calc_slots(prompt: str, c_malig: str, c_dist: str) -> str:
    replacement = "" if c_dist == "unknown" else f" with {c_dist} distribution"
    return prompt.replace("{C_MALIG}", c_malig).replace(" {C_DIST}", replacement)


def generate_gtr_prompt_sentence(
    key: str,
    n: int = 1,
    rng: Optional[random.Random] = None,
    **slots: str,
) -> str:
    """Sample ``n`` templates for ``key`` and slot-fill them into one string.

    Keys and slot semantics follow the reference
    (reference: generator.py:97-293): ``gtr_mass:True``, ``gtr_calc:True``,
    ``gtr_mass:True&gtr_calc:True``, ``no_gtr``, ``row.labels['birads']:True``,
    ``gtr_histology>0`` and the two architectural-distortion keys.
    """
    rnd = _rng(rng)
    sampled = rnd.sample(report_bank(key), n)

    if key in ("gtr_mass:True", "gtr_mass:True&gtr_calc:True"):
        m_marg = slots.get("M_MARG", "unknown")
        m_shape = slots.get("M_SHAPE", "unknown")
        m_malig = slots.get("M_MALIG", "unknown")
        filled = [_fill_mass_slots(p, m_marg, m_shape, m_malig) for p in sampled]
    elif key == "gtr_calc:True":
        c_malig = slots.get("C_MALIG", "unknown")
        c_dist = slots.get("C_DIST", "unknown")
        filled = [_fill_calc_slots(p, c_malig, c_dist) for p in sampled]
    elif "birads" in key:
        filled = [p.replace("{B_SCORE}", str(slots.get("B_SCORE"))) for p in sampled]
    elif key == "gtr_histology>0":
        filled = [p.replace("{HISTOLOGY}", str(slots.get("HISTOLOGY"))) for p in sampled]
    else:  # no_gtr, suspicious, architectural distortion keys
        filled = sampled

    return " ".join(filled)


def generate_label_prompt_sentence(
    label_name: Union[str, Sequence[str]],
    label_type: str,
    n: int = 20,
    template: Optional[str] = None,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """Generate ``n`` label sentences, filling ``{E}`` and ``{R}`` slots.

    ``{E}`` is the label expression (string or comma-joined list); each ``{R}``
    is a distinct random adverb from the shared selection bank
    (reference: generator.py:306-349).

    Note the default ``n=20`` is kept for signature parity but exceeds every
    template bank's size (max 8), so calling with defaults raises — exactly
    as it does in the reference (its banks are byte-identical); all real
    callers pass ``n=1``.
    """
    rnd = _rng(rng)
    bank = template_bank(template) if template else template_bank("HAS_MASS")
    adverbs = _banks()["random_selection_adverbs"]

    sentences = rnd.sample(list(bank[label_type]), n)
    out: List[str] = []
    for sentence in sentences:
        expression = label_name if isinstance(label_name, str) else ", ".join(label_name)
        sentence = sentence.replace("{E}", expression)
        picks = rnd.sample(adverbs, sentence.count("{R}"))
        for pick in picks:
            sentence = sentence.replace("{R}", pick, 1)
        out.append(sentence)
    return out


def generate_label_prompt_report(dataset, new_col: str, rng: Optional[random.Random] = None):
    """Build a shuffled multi-sentence pseudo-report per dataframe row.

    One sentence per label family — malignancy, mass presence, shape, margin —
    shuffled into random order (reference: generator.py:351-393).  Operates on
    a pandas DataFrame with the ingest schema of
    :func:`mmgclip_tpu.data.ingest.create_dataset_df`.
    """
    rnd = _rng(rng)
    banks = _banks()

    for i, row in dataset.iterrows():
        report: List[str] = []

        family = "benign" if row["image_label"] == 0 else "malignant"
        report.append(rnd.sample(banks["benign_malig"][family], 1)[0])

        report.append(
            generate_label_prompt_sentence(
                "mass", "positive" if row["has_mass"] else "negative", n=1, template="HAS_MASS", rng=rnd
            )[0]
        )

        shapes = sorted({str(v).lower() for v in row["mass_shape"] if v != -1})
        if not shapes:
            shape_kind, shapes = "no_shape", ["unknown"]
        elif len(shapes) == 1:
            shape_kind = "has_single_shape"
        else:
            shape_kind = "has_many_shapes"
        report.append(generate_label_prompt_sentence(shapes, shape_kind, n=1, template="MASS_SHAPE", rng=rnd)[0])

        margins = sorted({str(v).lower() for v in row["mass_margin"] if v != -1})
        if not margins:
            margin_kind, margins = "no_margin", ["unknown"]
        elif len(margins) == 1:
            margin_kind = "has_single_margin"
        else:
            margin_kind = "has_many_margins"
        report.append(generate_label_prompt_sentence(margins, margin_kind, n=1, template="MASS_MARGIN", rng=rnd)[0])

        rnd.shuffle(report)
        dataset.at[i, new_col] = " ".join(report)

    return dataset
