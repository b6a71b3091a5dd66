"""Micro-size copies of the cells for CPU tests: the configuration and
traffic files with the widths and counts cut to what a test can hold, run
through the same generators on the CPU."""

from __future__ import annotations

import copy
import json
import os

from portbench import manifest
from portbench.run import Context
from portbench.trace import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MICRO_TEXT = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 128,
              "max_position_embeddings": 128, "sequence_length": 32}


def _load(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def cell_files(workload: str):
    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, workload)
    config = _load(os.path.join(ROOT, manifest.config_entry(bench, cell["config"])["file"]))
    traffic = _load(manifest.traffic_path(cell["traffic"]))
    return bench, cell, config, traffic


def micro(workload: str, tmp_path, seconds: float = 0.5, seed: int = 2 ** 31 + 7):
    """-> Context of ``workload`` at micro size on the CPU."""
    _bench, cell, config, traffic = cell_files(workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["text_tower"].update(MICRO_TEXT)
    tower = config["image_tower"]
    if tower["arch"].startswith("convnext"):
        tower.update(depths=[1, 1, 2, 1], dims=[8, 16, 32, 768])
        config["overrides"] = list(config["overrides"]) + ["networks.image_encoder.config.micro=true"]
    else:
        tower.update(stage_sizes=[1, 1, 1, 1], width=8)
        config["overrides"] = list(config["overrides"]) + [
            "networks.image_encoder.config={micro: true}"]
    if traffic["generator"] == "store":
        traffic.update(images=4, height=70, width=52, batch_size=2, check_images=3)
    else:
        traffic.update(bank_rows=64, batch_size=8)
    workdir = str(tmp_path)
    return Context(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
                   tracing=False, workdir=workdir, device="cpu", spans=Spans())
