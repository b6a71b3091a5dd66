"""Report template assembly from cascade decision indices
(port of mmgclip_tpu/evaluation/report_text.py; host-side, byte-equal).
"""

from __future__ import annotations

import re

from ..prompts.generator import generate_gtr_prompt_sentence
from .report_cascade import BANKS


def generate_report(decisions, rng=None, bug_compat: bool = True):
    """Assemble the report from cascade decision indices
    (reference: generate_report.py:181-372).  Returns (text, report_dict).

    ``decisions`` comes from report_cascade.unpack_decisions — the whole
    decision tree is evaluated in ONE device computation; this
    function only does host-side template assembly on integer indices.

    ``bug_compat`` (default ON — the parity gate is *identical* generated
    reports) reproduces two quirks of the reference cascade verbatim:

    1. The calc-distribution sentence is selected with the MASS-TYPE argmax,
       not the distribution argmax (reference: generate_report.py:315
       ``class_list[int(clf_mass_type['similarities_argmax'])]``), which on
       the calc branch is always index 1 -> "regional".
    2. The architectural-distortion template key is inverted: argmax==1
       ("no evidence") keys the distortion-PRESENT gtr bank and vice versa
       (reference: generate_report.py:366-367).

    ``bug_compat=False`` uses the semantically correct mappings."""
    report = {
        "mass_type": None, "mass_malignancy": None, "mass_shape": None, "mass_margin": None,
        "calc_malignancy": None, "calc_distribution": None, "arch_distortion": None, "birads": None,
        "no_findings_report": None, "mass_report": None, "calc_report": None, "arch_dist_report": None,
    }

    top_idx = decisions["mass_type"]
    report["mass_type"] = BANKS["mass_type"][top_idx]

    if top_idx == 2:  # no findings
        report["arch_distortion"] = "Mammography showed no evidence of architectural distortion."
        report["birads"] = "BI-RADS score 1."
        report["no_findings_report"] = (
            report["mass_type"] + " " + report["arch_distortion"] + " " + report["birads"]
        )
    else:
        if top_idx == 0:  # mass branch
            malig_idx = decisions["mass_malignancy"]
            report["mass_malignancy"] = BANKS["mass_malignancy"][malig_idx]
            report["mass_shape"] = BANKS["mass_shape"][decisions["mass_shape"]]
            report["mass_margin"] = BANKS["mass_margin"][decisions["mass_margin"]]
            birads_bank = "birads_benign" if malig_idx == 0 else "birads_malignant"
            report["birads"] = BANKS[birads_bank][decisions[birads_bank]]

            m_malig = re.search(r"\b(benign|malignant)\b", report["mass_malignancy"], re.IGNORECASE)
            m_marg = re.search(r"\b(circumscribed|obscured|spiculated|ill defined)\b", report["mass_margin"], re.IGNORECASE)
            m_shape = re.search(r"\b(oval|round|irregular)\b", report["mass_shape"], re.IGNORECASE)
            b_score = re.search(r"\b(0|1|2|3|4|5|6)\b", report["birads"], re.IGNORECASE)

            report["mass_report"] = generate_gtr_prompt_sentence(
                "gtr_mass:True", n=1, rng=rng,
                M_MALIG=m_malig.group() if m_malig else "unknown",
                M_MARG=m_marg.group() if m_marg else "unknown",
                M_SHAPE=m_shape.group() if m_shape else "unknown",
            )
            report["mass_report"] = report["mass_report"][:-1] + ", " + generate_gtr_prompt_sentence(
                "row.labels['birads']:True", n=1, rng=rng,
                B_SCORE=b_score.group() if b_score else "unknown",
            )

        if top_idx == 1:  # calcification branch
            malig_idx = decisions["calc_malignancy"]
            report["calc_malignancy"] = BANKS["calc_malignancy"][malig_idx]
            # bug-compat: reference indexes the distribution bank with the
            # mass-type argmax (always 1 on this branch -> "regional")
            dist_idx = top_idx if bug_compat else decisions["calc_distribution"]
            report["calc_distribution"] = BANKS["calc_distribution"][dist_idx]
            birads_bank = "birads_benign" if malig_idx == 0 else "birads_malignant"
            report["birads"] = BANKS[birads_bank][decisions[birads_bank]]

            c_malig = re.search(r"\b(benign|malignant)\b", report["calc_malignancy"], re.IGNORECASE)
            c_dist = re.search(r"\b(diffuse|regional|grouped|linear|segmental)\b", report["calc_distribution"], re.IGNORECASE)
            b_score = re.search(r"\b(0|1|2|3|4|5|6)\b", report["birads"], re.IGNORECASE)

            report["calc_report"] = generate_gtr_prompt_sentence(
                "gtr_calc:True", n=1, rng=rng,
                C_MALIG=c_malig.group() if c_malig else "unknown",
                C_DIST=c_dist.group() if c_dist else "unknown",
            )
            report["calc_report"] = report["calc_report"][:-1] + ", " + generate_gtr_prompt_sentence(
                "row.labels['birads']:True", n=1, rng=rng,
                B_SCORE=b_score.group() if b_score else "unknown",
            )

        arch_idx = decisions["arch_distortion"]
        report["arch_distortion"] = BANKS["arch_distortion"][arch_idx]
        # index 0 is "displayed architectural distortion"; bug-compat keys the
        # banks inverted, exactly like the reference
        key_true = (arch_idx == 1) if bug_compat else (arch_idx == 0)
        report["arch_dist_report"] = generate_gtr_prompt_sentence(
            "gtr_is_architectural_distortion:True" if key_true else "gtr_is_architectural_distortion:False",
            n=1, rng=rng,
        )

    report_keys = ["no_findings_report", "mass_report", "calc_report", "arch_dist_report"]
    text = " ".join(report[key] for key in report_keys if report[key] is not None)
    return text, report
