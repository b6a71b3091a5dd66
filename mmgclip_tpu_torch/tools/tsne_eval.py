"""t-SNE embedding-space analysis (port of tools/tsne_eval.py; reference:
notebooks/tSNE_evaluation.ipynb).

    python -m mmgclip_tpu_torch.tools.tsne_eval --experiment_path yyyy-mm-dd/XX-XX-XX
        [--perplexity 30] [--out tsne] [--device cpu]

Embeds the experiment's dataset through the trained projection head, runs
the port's t-SNE (``utils/tsne.py``: scikit-learn's objective, schedule and
PCA init with the exact gradient, on ``--device``; the JAX tool runs
scikit-learn's Barnes-Hut) at ``min(perplexity, max(2, (N - 1) / 3))``,
and writes ``results/<out>/tsne_coords.csv`` (header and label columns as
the JAX tool writes them; ``x``, ``y`` float32 values printed as floats)
plus one scatter PNG per label family where matplotlib imports.  Runs on
the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import recompose
from ..data.datasets import get_dataset
from ..data.loader import DataLoaders
from ..ingest.encode import resolve_device
from ..serving import InferenceEngine
from ..utils.plot import _plt
from ..utils.tsne import tsne


def main(argv: Optional[List[str]] = None) -> Dict:
    """The entry point; returns ``{"embeddings", "coords", "prompt_labels",
    "csv", "kl_divergence"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", required=True,
                        help="Run folder inside outputs/ ('yyyy-mm-dd/XX-XX-XX').")
    parser.add_argument("--perplexity", type=float, default=30.0)
    parser.add_argument("--out", default="tsne", help="Subdir of the run's results dir.")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    experiment_path = args.experiment_path
    if not os.path.isdir(experiment_path):
        experiment_path = os.path.join("outputs", experiment_path)
    cfg = recompose(experiment_path)
    cfg.checkpoints.checkpoints_export_dir = os.path.join(experiment_path, "checkpoints")

    engine = InferenceEngine.from_experiment(experiment_path, device=device)
    dataset = get_dataset(cfg.dataset.eval.dataset.name)(config=cfg)
    loader = DataLoaders(config=cfg, dataset_split=dataset).get_dataloader(
        batch_size=32, shuffle=False, drop_last=False, collate_fn=dataset.collate_fn)
    embeddings, prompt_labels = [], []
    for batch in loader:
        # per-batch results stay on the device; one read back below
        embeddings.append(engine.image_embeddings(np.asarray(batch["image_features"])))
        prompt_labels.extend(batch["prompt_labels"])
    embeddings = torch.cat(embeddings).float().cpu().numpy()
    engine.close()

    perplexity = min(args.perplexity, max(2.0, (len(embeddings) - 1) / 3))
    result = tsne(embeddings, perplexity=perplexity, device=device)
    coords = result.embedding

    out_dir = os.path.join(experiment_path, "results", args.out)
    os.makedirs(out_dir, exist_ok=True)
    label_families = sorted(prompt_labels[0].keys()) if prompt_labels else []
    csv_path = os.path.join(out_dir, "tsne_coords.csv")
    with open(csv_path, "w") as fh:
        fh.write("x,y," + ",".join(label_families) + "\n")
        for (x, y), labels in zip(coords, prompt_labels):
            fh.write(f"{x},{y}," + ",".join(str(labels[k]) for k in label_families) + "\n")

    plt = _plt("t-SNE scatter plots") if label_families else None
    for family in label_families if plt is not None else ():
        values = [str(p[family]) for p in prompt_labels]
        plt.figure(figsize=(6, 5))
        for value in sorted(set(values)):
            idx = [i for i, v in enumerate(values) if v == value]
            plt.scatter(coords[idx, 0], coords[idx, 1], s=14, label=value, alpha=0.75)
        plt.legend(fontsize=7)
        plt.title(f"t-SNE of projected image embeddings — {family}")
        plt.tight_layout()
        path = os.path.join(out_dir, f"tsne_{family}.png")
        plt.savefig(path, dpi=120)
        plt.close()
        print("wrote", path)
    print("wrote", csv_path)
    return {"embeddings": embeddings, "coords": coords, "prompt_labels": prompt_labels,
            "csv": csv_path, "kl_divergence": result.kl_divergence}


if __name__ == "__main__":
    main()
