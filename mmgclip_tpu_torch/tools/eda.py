"""Exploratory data analysis over the annotated dataset (port of
tools/eda.py; reference: notebooks/EDA.ipynb).

    python -m mmgclip_tpu_torch.tools.eda [--config-name train_binary_class_clf]
        [dataset.config.annotated_dataset_path=...] [--out eda_report]

The same statistics as the JAX tool (image-label balance, per-region
multiplicity, mass-margin/shape coverage, annotation inconsistencies,
label distributions) over the port's dataset rows (``data.ingest``'s list
of dicts in place of the pandas frame), written as ``eda.txt`` (byte-equal
to the JAX tool's) plus histogram PNGs where matplotlib imports.  Host
work only: no tensors, no device.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter
from typing import Dict, List, Optional

from ..cli import DEFAULT_CONFIG_DIR
from ..config import compose
from ..data.ingest import create_dataset_df
from ..utils.plot import _plt


def _present(values) -> List:
    return [v for v in values if v != -1]


def _flat(lists) -> List[str]:
    # stringify: annotation values may be None / ints
    return [str(val) for sublist in lists for val in _present(sublist)]


def _combined(lists) -> List[str]:
    return [" / ".join(sorted({str(v) for v in _present(lst)})) for lst in lists if _present(lst)]


def analyse(rows: List[Dict]) -> Dict:
    """The EDA.ipynb statistics over ``create_dataset_df`` rows (the JAX
    tool's ``analyse`` over its frame, with pandas' ``value_counts`` order:
    by count, ties in first-seen order)."""
    margins = [row["mass_margin"] for row in rows]
    shapes = [row["mass_shape"] for row in rows]
    has_margin = [bool(_present(lst)) for lst in margins]
    has_shape = [bool(_present(lst)) for lst in shapes]
    label_counts = Counter(row["image_label"] for row in rows)
    return {
        "n_images": len(rows),
        "image_label_counts": dict(sorted(label_counts.items(), key=lambda kv: -kv[1])),
        "flag_counts": {col: int(sum(bool(row[col]) for row in rows))
                        for col in ("has_mass", "has_calc", "has_architectural_distortion")},
        "n_has_mass_margin": sum(has_margin),
        "n_has_mass_shape": sum(has_shape),
        "n_multiple_margins": sum(len(_present(lst)) > 1 for lst in margins),
        "n_multiple_shapes": sum(len(_present(lst)) > 1 for lst in shapes),
        # annotation inconsistencies: one attribute without the other
        "shape_without_margin": [row["image_id"] for row, m, s in zip(rows, has_margin, has_shape)
                                 if s and not m],
        "margin_without_shape": [row["image_id"] for row, m, s in zip(rows, has_margin, has_shape)
                                 if m and not s],
        "margin_label_counts": dict(Counter(_flat(margins))),
        "shape_label_counts": dict(Counter(_flat(shapes))),
        "combined_margin_counts": dict(Counter(_combined(margins))),
        "combined_shape_counts": dict(Counter(_combined(shapes))),
    }


def format_report(stats: Dict) -> str:
    lines = ["# EDA report", "", f"images: {stats['n_images']}", ""]
    lines.append("image_label counts (0=benign, 1=malignant, 2=uncertain):")
    for label, count in sorted(stats["image_label_counts"].items()):
        lines.append(f"  {label}: {count}")
    lines.append("")
    for col, count in stats["flag_counts"].items():
        lines.append(f"{col}: {count}")
    lines += [
        "",
        f"views with >=1 mass_margin: {stats['n_has_mass_margin']}",
        f"views with >=1 mass_shape:  {stats['n_has_mass_shape']}",
        f"views with multiple margins: {stats['n_multiple_margins']}",
        f"views with multiple shapes:  {stats['n_multiple_shapes']}",
        "",
        f"inconsistent (shape without margin): {stats['shape_without_margin']}",
        f"inconsistent (margin without shape): {stats['margin_without_shape']}",
        "",
        "mass_margin label distribution:",
    ]
    for label, count in sorted(stats["margin_label_counts"].items()):
        lines.append(f"  {label}: {count}")
    lines.append("mass_shape label distribution:")
    for label, count in sorted(stats["shape_label_counts"].items()):
        lines.append(f"  {label}: {count}")
    lines.append("combined margin strings (multi-region views joined by ' / '):")
    for label, count in sorted(stats["combined_margin_counts"].items()):
        lines.append(f"  {label}: {count}")
    lines.append("combined shape strings:")
    for label, count in sorted(stats["combined_shape_counts"].items()):
        lines.append(f"  {label}: {count}")
    return "\n".join(lines) + "\n"


def save_histograms(stats: Dict, out_dir: str) -> List[str]:
    """The label histograms as PNGs (none without matplotlib) -> paths."""
    written = []
    for name in ("margin_label_counts", "shape_label_counts"):
        counts = stats[name]
        plt = _plt(f"{name} histogram") if counts else None
        if plt is None:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        keys = sorted(counts)
        ax.bar([str(k) for k in keys], [counts[k] for k in keys], edgecolor="black")
        ax.set_title(f"Histogram of {name.replace('_counts', '').replace('_', ' ')}s")
        ax.set_xlabel("Labels")
        ax.set_ylabel("Frequency")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        fig.tight_layout()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written


def main(argv: Optional[List[str]] = None) -> str:
    """The entry point; returns the report text."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_binary_class_clf")
    parser.add_argument("--out", default="eda_report", help="Output directory.")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides.")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    cfg = compose(DEFAULT_CONFIG_DIR, args.config_name, overrides=args.overrides)
    stats = analyse(create_dataset_df(cfg))
    report = format_report(stats)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "eda.txt"), "w") as fh:
        fh.write(report)
    save_histograms(stats, args.out)
    print(report)
    print(f"Report + histograms written to {args.out}/")
    return report


if __name__ == "__main__":
    main()
