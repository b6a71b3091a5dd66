"""Structured report generation by cascaded zero-shot ranking (port of the
root ``generate_report.py``; reference: generate_report.py:1-372).

    python -m mmgclip_tpu_torch.generate_report --experiment_path yyyy-mm-dd/XX-XX-XX
        --image_id p0200000102cl [--seed 42] [--device cpu]
    python -m mmgclip_tpu_torch.generate_report --experiment_path ... --exam_id 2000000102

Loads a trained run, encodes one image or every file of one exam dir through
the feature store's encode program, walks the BI-RADS decision cascade (one
masked argmax per prompt bank against the cached prompt table) and prints
the report assembled from the template banks.  A failed encode is appended
to ``<run>/failed_inference.txt`` and re-raised.  Runs on the CUDA card
unless ``--device`` names another device; with no card and no ``--device``
it raises before any work.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

from .config import recompose
from .data.paths import create_exam_path, create_path
from .data.tokenizer import Tokenizer
from .evaluation.report_cascade import decide
from .evaluation.report_text import generate_report
from .ingest.encode import (build_encode_program, host_prepool, load_convnext_tower,
                            parse_ingest_knobs, resolve_device)
from .ingest.png_reader import decode_png
from .models.clip import MMGCLIP
from .ops.fusion import fuse_views
from .training.checkpoint import load_checkpoint
from .utils.seeding import seeding
from .weights import load_clip_params


def encode_inputs(cfg, image_id: Optional[str] = None, exam_id: Optional[str] = None,
                  device=None) -> torch.Tensor:
    """One image, or the fused views of one exam -> [1, d] features on the
    device (reference: generate_report.py:77-163).

    Rides the encode program the feature store uses (``build_encode_program``
    with the run's ingest knobs), so a run trained on resized or windowed
    features sees identically prepared pixels here."""
    device = resolve_device(device)
    module, cn_config = load_convnext_tower(cfg, device=device)
    resize_hw, resize_method, resize_precision, window, prepool = parse_ingest_knobs(cfg)
    program = build_encode_program(module, cn_config.in_channels, window=window,
                                   resize_hw=resize_hw, resize_method=resize_method,
                                   resize_precision=resize_precision, prepool=prepool)

    def encode_one(path: str) -> torch.Tensor:
        pixels = decode_png(path)
        if prepool:
            sums, scale = host_prepool(pixels[None], prepool)
            return program(torch.from_numpy(sums).to(device), native_hw=pixels.shape[:2],
                           scale=scale)[0]
        return program(torch.from_numpy(pixels).to(device)[None])[0]

    base = cfg.dataset.config.base_dataset_path
    if image_id:
        if not (len(image_id) == 13 and image_id[0] == "p" and image_id[-2:] in ["cl", "cr", "ml", "mr"]):
            raise ValueError(f"Wrong value passed to image_id: {image_id}.")
        path = create_path(image_id, base_dataset_path=base)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"No image found at `{path}`.")
        return encode_one(path)[None, :]

    if not exam_id or len(exam_id) != 10:
        raise ValueError(f"Wrong value passed to exam_id {exam_id}.")
    path = create_exam_path(exam_id, base_dataset_path=base)
    if not (os.path.isdir(path) and os.listdir(path)):
        raise FileNotFoundError(f"No exam found inside `{path}`.")
    # reference parity: EVERY file of the exam dir is encoded, unfiltered and
    # uncapped (reference: generate_report.py:110-126), so a sidecar file
    # fails the exam into failed_inference.txt; the serving engine filters
    # PNGs and caps the views instead (serving.py::encode_exam)
    views = torch.stack([encode_one(os.path.join(path, v)) for v in sorted(os.listdir(path))])
    fused = fuse_views(views, cfg.dataset.config.concatenate_features_method)
    return fused[None, :] if fused.dim() == 1 else fused


def main(argv: Optional[List[str]] = None) -> Tuple[Dict[str, int], str]:
    """The entry point; returns the decisions and the printed report."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True,
                        help="Run folder inside outputs/ ('yyyy-mm-dd/XX-XX-XX').")
    parser.add_argument("--image_id", type=str, default=None,
                        help="Image id `p{10 digits}{cl|cr|ml|mr}`.")
    parser.add_argument("--exam_id", type=str, default=None, help="Exam id (10 digits).")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed for template sampling (default: config seed).")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    # the run folder inside outputs/ or an existing / absolute run dir, as
    # evaluate_clip and serve resolve it
    experiment_path = args.experiment_path
    if not os.path.isabs(experiment_path) and not os.path.isdir(experiment_path):
        experiment_path = os.path.join("outputs", experiment_path)
    cfg = recompose(experiment_path)
    cfg.base.export_dir = experiment_path
    cfg.base.results_export_dir = os.path.join(experiment_path, "results")
    cfg.checkpoints.checkpoints_export_dir = os.path.join(experiment_path, "checkpoints")

    rngs = seeding(int(args.seed if args.seed is not None else cfg.base.seed))
    tokenizer = Tokenizer.from_pretrained(cfg.tokenizer.config.tokenizer_name,
                                          sequence_length=int(cfg.tokenizer.config.sequence_length))
    model = MMGCLIP(cfg, seed=int(cfg.base.seed), vocab_size=tokenizer.vocab_size)
    ckp_path = os.path.join(cfg.checkpoints.checkpoints_export_dir, cfg.checkpoints.checkpoints_file_name)
    load_clip_params(model, load_checkpoint(ckp_path)["params"])
    model.to(device).eval()

    try:
        image_embeddings = encode_inputs(cfg, image_id=args.image_id, exam_id=args.exam_id,
                                         device=device)
    except Exception as exc:
        with open(os.path.join(experiment_path, "failed_inference.txt"), "a") as fh:
            fh.write(f"{args.image_id or args.exam_id}\n{exc}\n\n")
        raise

    decisions = decide(model, tokenizer, image_embeddings)
    bug_compat = bool(cfg.get_path("generate_report.bug_compat", True))
    text, _report = generate_report(decisions, rng=rngs.host, bug_compat=bug_compat)
    print("Generated Report: ", text)
    return decisions, text


if __name__ == "__main__":
    main()
