"""Aggregate N experiment runs into one comparison table + ROC overlays
(port of tools/compare_runs.py).

CLI counterpart of the reference's cross-experiment reporting notebooks
(reference: notebooks/models_performance_reporting.ipynb cells 3/5/6,
notebooks/evaluate.ipynb): collect each run's ``results.json`` into the
BASELINE.md-shaped attribute x configuration AUROC table (plus accuracy /
F1 tables), and overlay the runs' real ROC curves per attribute from the
``model_*_roc_curves.json`` data the Evaluator persists, with no
re-evaluation.  ``comparison.{csv,md,txt}`` are byte-equal to the JAX
tool's on the same run directories; the ROC overlay and radar PNGs are
written where matplotlib imports and skipped with a warning elsewhere.

Usage:
  python -m mmgclip_tpu_torch.tools.compare_runs RUN_DIR [RUN_DIR ...] \
      [--labels NAME ...] [--out outputs/comparison]

RUN_DIR may be the experiment dir (results/ nested), the results dir, or a
results.json path.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluation import metrics as M
from ..utils.logging import logger
from ..utils.table import Table


def _resolve_results_dir(path: str) -> Tuple[str, str]:
    """RUN_DIR -> (results.json path, results dir)."""
    if os.path.isfile(path) and path.endswith(".json"):
        return path, os.path.dirname(path)
    for candidate in (path, os.path.join(path, "results")):
        rj = os.path.join(candidate, "results.json")
        if os.path.isfile(rj):
            return rj, candidate
    raise FileNotFoundError(f"No results.json under {path!r}")


def load_run(path: str) -> Dict:
    """One run's metrics: {key: {auc, accuracy, f1score}} + raw ROC curves."""
    rj, results_dir = _resolve_results_dir(path)
    with open(rj) as fh:
        results = json.load(fh)
    metrics: Dict[str, Dict[str, float]] = {}
    curves: Dict[str, List[Dict]] = {}
    for key, node in results.items():
        zs = node.get("zeroshot_label_prompt") if isinstance(node, dict) else None
        if not isinstance(zs, dict):
            continue
        # binary tasks carry the bootstrap CI mean; multiclass the macro mean
        # (the Evaluator writes non-finite values as JSON null — map to nan)
        fnum = lambda v: float("nan") if v is None else float(v)  # noqa: E731
        auc = zs.get("auc_ci_mean", zs.get("mean_auc", float("nan")))
        metrics[key] = {
            "auc": fnum(auc),
            "accuracy": fnum(zs.get("accuracy", float("nan"))),
            "f1score": fnum(zs.get("f1score", float("nan"))),
            "auc_ci_lower": fnum(zs.get("auc_ci_lower", float("nan"))),
            "auc_ci_higher": fnum(zs.get("auc_ci_higher", float("nan"))),
        }
        # one method's curves only — merging zeroshot and
        # zeroshot_label_prompt files would average cross-method curves.
        # Prefer zeroshot_label_prompt: it is the method the tables above
        # are built from
        for subdir in ("zeroshot_label_prompt", "zeroshot"):
            curve_file = os.path.join(
                results_dir, subdir, f"model_{key}_roc_curves.json"
            )
            if os.path.isfile(curve_file):
                with open(curve_file) as cf:
                    curves[key] = json.load(cf)
                break
    return {"metrics": metrics, "curves": curves}


def _metric_table(runs: List[Dict], labels: List[str], metric: str) -> Table:
    keys: List[str] = []
    for run in runs:
        for key in run["metrics"]:
            if key not in keys:
                keys.append(key)
    table = Table([f"Metric ({metric.upper() if metric == 'auc' else metric})"] + labels)
    for key in keys:
        table.add_row(
            [key]
            + [run["metrics"].get(key, {}).get(metric, float("nan")) for run in runs]
        )
    return table


def _markdown(table: Table) -> str:
    def fmt(v):
        return f"{v:.4f}" if isinstance(v, float) else str(v)

    lines = ["| " + " | ".join(table.field_names) + " |",
             "|" + "|".join(["---"] * len(table.field_names)) + "|"]
    lines += ["| " + " | ".join(fmt(v) for v in row) + " |" for row in table.rows]
    return "\n".join(lines)


def _mean_curve(entries: List[Dict]) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """A run's representative ROC for one attribute: the positive-class curve
    for binary tasks, the vertically averaged curve otherwise.  Binary is
    detected from the TASK (two prompts, one negated), not from how many
    classes survived degenerate splits — a 4-class attribute with two
    curve-less classes must still average, not pick one class's curve."""
    usable = [e for e in entries if len(e.get("fpr", [])) > 1]
    if not usable:
        return None
    is_binary = len(entries) == 2 and any(
        e.get("name", "").lower().startswith("no ") for e in entries
    )
    if is_binary:
        # select the POSITIVE class by name, not by position in `usable`: if
        # its curve is degenerate but the 'No X' curve survived, usable[-1]
        # would be the negated class — silently presented as the run's
        # result (advisor r3).  No positive curve -> skip this run.
        positives = [e for e in usable if not e.get("name", "").lower().startswith("no ")]
        if not positives:
            return None
        e = positives[-1]
        return np.asarray(e["fpr"]), np.asarray(e["tpr"]), float(e["auc"])
    if len(usable) == 1:
        e = usable[0]
        return np.asarray(e["fpr"]), np.asarray(e["tpr"]), float(e["auc"])
    mean_fpr, mean_tpr, _std, mean_auc = M.mean_roc_curve(
        [(np.asarray(e["fpr"]), np.asarray(e["tpr"])) for e in usable]
    )
    return mean_fpr, mean_tpr, float(mean_auc)


def _overlay_rocs(runs: List[Dict], labels: List[str], out_dir: str) -> List[str]:
    written = []
    keys = sorted({k for run in runs for k in run["curves"]})
    for key in keys:
        per_run = [(label, _mean_curve(run["curves"].get(key, [])))
                   for label, run in zip(labels, runs)]
        per_run = [(label, c) for label, c in per_run if c is not None]
        if not per_run:
            continue
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception as exc:  # plotting must never fail the aggregation
            logger.warning(f"ROC overlay skipped (matplotlib unavailable: {exc})")
            return written
        fig, ax = plt.subplots()
        for label, (fpr, tpr, auc) in per_run:
            ax.plot(fpr, tpr, lw=2, label=f"{label} (AUC = {auc:.4f})")
        ax.plot([0, 1], [0, 1], color="navy", lw=2, linestyle="--")
        ax.set_xlabel("False Positive Rate")
        ax.set_ylabel("True Positive Rate")
        ax.set_title(f"ROC comparison — {key}")
        ax.legend(loc="lower right", fontsize=8)
        path = os.path.join(out_dir, f"roc_overlay_{key}.png")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


def _radar_chart(auc_table: Table, labels: List[str], out_dir: str) -> Optional[str]:
    """The thesis' radar figure: one polygon per configuration over the
    attribute axes (reference: models_performance_reporting.ipynb radar
    cells feeding BASELINE.md's tables)."""
    rows = [row for row in auc_table.rows
            if all(isinstance(v, float) and np.isfinite(v) for v in row[1:])]
    dropped = [row[0] for row in auc_table.rows if row not in rows]
    if dropped:
        logger.info(f"Radar: dropped attributes missing in some run: {dropped}.")
    if len(rows) < 3:  # a radar needs at least 3 axes to be readable
        if auc_table.rows:
            logger.info(f"Radar skipped: only {len(rows)} complete attribute axes (<3).")
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as exc:
        logger.warning(f"Radar chart skipped (matplotlib unavailable: {exc})")
        return None
    attributes = [row[0] for row in rows]
    angles = np.linspace(0, 2 * np.pi, len(attributes), endpoint=False).tolist()
    fig, ax = plt.subplots(subplot_kw={"projection": "polar"}, figsize=(7, 7))
    for idx, label in enumerate(labels):
        values = [row[1 + idx] for row in rows]
        ax.plot(angles + angles[:1], values + values[:1], lw=2, label=label)
        ax.fill(angles + angles[:1], values + values[:1], alpha=0.1)
    ax.set_xticks(angles)
    ax.set_xticklabels(attributes, fontsize=8)
    ax.set_ylim(0, 1)
    ax.set_title("Zero-shot AUROC per attribute")
    ax.legend(loc="lower right", bbox_to_anchor=(1.2, 0.0), fontsize=8)
    path = os.path.join(out_dir, "radar_auroc.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def compare_runs(paths: List[str], labels: Optional[List[str]] = None,
                 out_dir: str = "outputs/comparison") -> Dict:
    if labels is None:
        labels = [os.path.basename(os.path.normpath(p)) or f"run{i}"
                  for i, p in enumerate(paths)]
        if len(set(labels)) != len(labels):  # disambiguate identical basenames
            labels = [f"{label}#{i}" for i, label in enumerate(labels)]
    if len(labels) != len(paths):
        raise ValueError(f"{len(labels)} labels for {len(paths)} runs")
    runs = [load_run(p) for p in paths]
    os.makedirs(out_dir, exist_ok=True)

    tables = {m: _metric_table(runs, labels, m) for m in ("auc", "accuracy", "f1score")}
    text = "\n\n".join(str(t) for t in tables.values())
    with open(os.path.join(out_dir, "comparison.txt"), "w") as fh:
        fh.write(text + "\n")
    md = "\n\n".join(
        f"## {title}\n\n{_markdown(table)}"
        for title, table in (
            ("Zero-shot AUROC per attribute", tables["auc"]),
            ("Accuracy", tables["accuracy"]),
            ("F1", tables["f1score"]),
        )
    )
    with open(os.path.join(out_dir, "comparison.md"), "w") as fh:
        fh.write(md + "\n")
    with open(os.path.join(out_dir, "comparison.csv"), "w") as fh:
        fh.write("metric,attribute," + ",".join(labels) + "\n")
        for metric, table in tables.items():
            for row in table.rows:
                fh.write(metric + "," + ",".join(str(v) for v in row) + "\n")
    pngs = _overlay_rocs(runs, labels, out_dir)
    radar = _radar_chart(tables["auc"], labels, out_dir)
    print(text)
    logger.info(f"Wrote comparison tables + {len(pngs)} ROC overlays to {out_dir}.")
    return {"labels": labels, "tables": tables, "roc_overlays": pngs, "radar": radar}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("runs", nargs="+", help="Experiment/run directories.")
    parser.add_argument("--labels", nargs="*", default=None,
                        help="Column names (default: run dir basenames).")
    parser.add_argument("--out", default="outputs/comparison")
    args = parser.parse_args(argv)
    return compare_runs(args.runs, labels=args.labels, out_dir=args.out)


if __name__ == "__main__":
    main()
