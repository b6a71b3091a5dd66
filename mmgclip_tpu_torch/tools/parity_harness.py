"""AUC parity harness: compare a run's zero-shot AUCs with the reference's
published numbers (port of tools/parity_harness.py).

    python -m mmgclip_tpu_torch.tools.parity_harness --results outputs/<run>/results/results.json \
        [--configuration image-prompts] [--gate]

Reads an experiment's ``results.json`` (written by the Evaluator) and prints
the per-attribute delta against the reference table mirrored from
BASELINE.md (the thesis-figure numbers of
``models_performance_reporting.ipynb`` cell 6): the JAX tool's table, lines
and exit codes.  ``--gate`` exits 1 when an attribute is missing or NaN,
or when the worst |delta| exceeds 0.005 AUC.  No tensors, no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# reference zero-shot AUROC (BASELINE.md; models_performance_reporting.ipynb cell 6)
REFERENCE_AUC = {
    "image-prompts": {
        "BenignMalignantDatasetLabels": 0.931,
        "MassShapeLabels": 0.727,
        "MassMarginLabels": 0.715,
        "HasCalcification": 0.680,
        "HasArchDistortion": 0.682,
        "HasMassLabels": 0.663,
    },
    "exam-prompts": {
        "BenignMalignantDatasetLabels": 0.916,
        "MassShapeLabels": 0.700,
        "MassMarginLabels": 0.639,
        "HasCalcification": 0.736,
        "HasArchDistortion": 0.717,
        "HasMassLabels": 0.678,
    },
    "exam-reports": {
        "BenignMalignantDatasetLabels": 0.828,
        "MassShapeLabels": 0.596,
        "MassMarginLabels": 0.560,
        "HasCalcification": 0.567,
        "HasArchDistortion": 0.637,
        "HasMassLabels": 0.475,
    },
    "exam-reports-prompts": {
        "BenignMalignantDatasetLabels": 0.847,
        "MassShapeLabels": 0.848,
        "MassMarginLabels": 0.594,
        "HasCalcification": 0.683,
        "HasArchDistortion": 0.646,
        "HasMassLabels": 0.527,
    },
}


def extract_mean_auc(label_prompt_results: dict) -> float:
    """Mean per-class AUC from a zeroshot_label_prompt result dict; for
    binary tasks uses the bootstrap mean when present."""
    # the Evaluator writes non-finite values as JSON null — map to nan
    fnum = lambda v: float("nan") if v is None else float(v)  # noqa: E731
    if "auc_ci_mean" in label_prompt_results:
        return fnum(label_prompt_results["auc_ci_mean"])
    if "mean_auc" in label_prompt_results:
        return fnum(label_prompt_results["mean_auc"])
    aucs = [
        v["auc"] for v in label_prompt_results.values()
        if isinstance(v, dict) and isinstance(v.get("auc"), (int, float))
        and v["auc"] == v["auc"]
    ]
    return sum(aucs) / len(aucs) if aucs else float("nan")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", required=True, help="Path to results.json")
    parser.add_argument("--configuration", default="image-prompts", choices=sorted(REFERENCE_AUC))
    parser.add_argument("--gate", action="store_true", help="Exit nonzero when |delta| > 0.005")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    with open(args.results) as fh:
        results = json.load(fh)
    reference = REFERENCE_AUC[args.configuration]

    rows = []
    worst = 0.0
    incomparable = []
    for enum_name, ref_auc in reference.items():
        entry = results.get(enum_name, {}).get("zeroshot_label_prompt")
        if not entry:
            rows.append((enum_name, ref_auc, None, None))
            incomparable.append(enum_name)
            continue
        ours = extract_mean_auc(entry)
        if ours != ours:  # NaN: evaluation produced nothing comparable
            rows.append((enum_name, ref_auc, None, None))
            incomparable.append(enum_name)
            continue
        delta = ours - ref_auc
        worst = max(worst, abs(delta))
        rows.append((enum_name, ref_auc, ours, delta))

    print(f"configuration: {args.configuration}")
    print(f"{'attribute':34s} {'reference':>9s} {'ours':>9s} {'delta':>9s}")
    for name, ref_auc, ours, delta in rows:
        ours_s = f"{ours:.4f}" if ours is not None else "missing"
        delta_s = f"{delta:+.4f}" if delta is not None else "-"
        print(f"{name:34s} {ref_auc:9.4f} {ours_s:>9s} {delta_s:>9s}")

    if args.gate:
        if incomparable:
            # missing/NaN attributes must FAIL the gate — a run that
            # produced nothing comparable is not parity
            print(f"PARITY GATE FAILED: no comparable AUC for {incomparable}")
            sys.exit(1)
        if worst > 0.005:
            print(f"PARITY GATE FAILED: worst |delta| = {worst:.4f} > 0.005")
            sys.exit(1)
        print(f"parity gate passed (worst |delta| = {worst:.4f})")


if __name__ == "__main__":
    main()
