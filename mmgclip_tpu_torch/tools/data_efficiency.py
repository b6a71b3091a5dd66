"""Data-efficiency sweep: train at several training-set fractions, collect
AUCs (port of tools/data_efficiency.py).

    python -m mmgclip_tpu_torch.tools.data_efficiency --config-name train_binary_class_clf \
        --fractions 0.1 0.5 1.0 --out sweep_dir [--device cpu] [key=value overrides ...]

The reference ships the knob (``configs/dataset/percentage/p{10,20,50,70,100}.yaml``
and ``dataloader_percentage``) but runs each fraction by hand.  This runs
``train.run`` once per fraction under ``<out>/p<percent>`` (each with its
``.hydra`` snapshot, byte-equal to the JAX tool's), then writes
``data_efficiency.csv`` (fraction, enum class, method, mean AUC) and, where
matplotlib imports, an AUC-vs-fraction plot.  Runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from .. import train
from ..cli import DEFAULT_CONFIG_DIR
from ..config import Config, compose, save_snapshot
from ..ingest.encode import resolve_device
from ..utils.plot import _plt


def sweep_config(config_name: str, fraction: float, out_dir: str, overrides: Sequence[str]):
    """The composed config of one fraction's run -> (config, run dir)."""
    tag = int(round(fraction * 100))
    run_dir = os.path.join(out_dir, f"p{tag}")
    cfg = compose(DEFAULT_CONFIG_DIR, config_name, overrides=list(overrides), run_dir=run_dir)
    cfg.dataset.percentage = Config({"name": f"{tag}percent", "config": {"percentage": fraction}})
    cfg.base.export_dir = run_dir
    cfg.base.results_export_dir = os.path.join(run_dir, "results")
    cfg.base.tensorboard_export_dir = os.path.join(run_dir, "runs")
    cfg.checkpoints.checkpoints_export_dir = os.path.join(run_dir, "checkpoints")
    return cfg, run_dir


def run_sweep(config_name: str, fractions: Sequence[float], out_dir: str,
              overrides: Sequence[str], device=None) -> List[Dict]:
    """Train each fraction -> rows {fraction, enum_class, method, mean_auc}."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for fraction in fractions:
        cfg, run_dir = sweep_config(config_name, fraction, out_dir, overrides)
        save_snapshot(cfg, run_dir)
        print(f"== fraction {fraction} -> {run_dir} ==")
        train.run(cfg, device=device)

        with open(os.path.join(run_dir, "results", "results.json")) as fh:
            results = json.load(fh)
        for enum_class, methods in results.items():
            for method, metrics in methods.items():
                if isinstance(metrics, dict) and "mean_auc" in metrics:
                    # non-finite values arrive as JSON null: map to nan
                    auc = metrics["mean_auc"]
                    rows.append({"fraction": fraction, "enum_class": enum_class, "method": method,
                                 "mean_auc": float("nan") if auc is None else auc})
    return rows


def write_outputs(rows: List[Dict], out_dir: str) -> str:
    """``data_efficiency.csv`` (+ the PNG where matplotlib imports) -> CSV path."""
    csv_path = os.path.join(out_dir, "data_efficiency.csv")
    with open(csv_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["fraction", "enum_class", "method", "mean_auc"])
        writer.writeheader()
        writer.writerows(rows)

    plt = _plt("data-efficiency plot")
    if plt is None:
        return csv_path
    by_class: Dict = {}
    for row in rows:
        by_class.setdefault((row["enum_class"], row["method"]), []).append(
            (row["fraction"], row["mean_auc"]))
    fig, ax = plt.subplots(figsize=(6, 4))
    for (enum_class, method), points in sorted(by_class.items()):
        points.sort()
        ax.plot([p[0] for p in points], [p[1] for p in points],
                marker="o", label=f"{enum_class} ({method})")
    ax.set_xlabel("training-set fraction")
    ax.set_ylabel("mean zero-shot AUC")
    ax.set_title("Data efficiency")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "data_efficiency.png"), dpi=100)
    plt.close(fig)
    return csv_path


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """The entry point; returns the rows."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_binary_class_clf")
    parser.add_argument("--fractions", type=float, nargs="+", default=[0.1, 0.2, 0.5, 0.7, 1.0])
    parser.add_argument("--out", default="outputs/data_efficiency")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides.")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    rows = run_sweep(args.config_name, args.fractions, args.out, args.overrides, device=device)
    csv_path = write_outputs(rows, args.out)
    print(f"Sweep complete: {csv_path}")
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
