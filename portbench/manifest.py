"""``BENCHMARK.json``: loading, the files it names, and the rules it must follow.

Everything of one cell is found by name: the configuration's file from its
entry, the traffic mix at ``portbench/traffic/<traffic>.json`` (whose
``generator`` names the general generator in ``portbench/generators/`` that reads
it), and each per-layer metric's reader at
``portbench/layer_metrics/<metric>.py``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", name + ".json")


def reader_path(metric: str) -> str:
    return os.path.join(HERE, "layer_metrics", metric + ".py")


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: Dict, name: str) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _in(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: Dict, cell_name: str) -> List[Dict]:
    return [m for m in manifest["end_to_end"] if _in(m, cell_name)]


def per_layer(manifest: Dict, cell_name: str) -> List[Dict]:
    moved = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"] if _in(m, cell_name) and m["moves"] in moved]


def problems(manifest: Dict, root: str) -> List[str]:
    """Every way the manifest breaks the rules this file can check."""
    out = []
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")
    names = []
    for kind, keys in (("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS),
                       ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for entry in manifest.get(kind, []):
            extra = set(entry) - keys - ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
            if set(entry) & keys != keys or extra:
                out.append(f"{kind} entry {entry.get('name')}: keys {sorted(entry)}")
            if not NAME.match(str(entry.get("name", ""))):
                out.append(f"{kind} name {entry.get('name')!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                out.append(f"unit {entry['unit']!r} of {entry['name']}")
            if "better" in entry and entry["better"] not in ("lower", "higher"):
                out.append(f"better {entry['better']!r} of {entry['name']}")
            names.append((kind, entry.get("name")))
    for kind in ("configs", "workloads"):
        seen = [n for k, n in names if k == kind]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate {kind} names")
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    if len(metrics) != len(set(metrics)):
        out.append("duplicate metric names")
    configs = {c["name"]: c for c in manifest.get("configs", [])}
    for c in configs.values():
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']} missing")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"reduced key {key!r}")
    e2e_names = {m["name"] for m in manifest.get("end_to_end", [])}
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for m in manifest.get("end_to_end", []):
        if not 0 < m["bound"] <= 0.25:
            out.append(f"bound of {m['name']}")
    for w in manifest.get("workloads", []):
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if not NAME.match(w["traffic"]) or not os.path.isfile(traffic_path(w["traffic"])):
            out.append(f"{w['name']}: traffic file for {w['traffic']!r} missing")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        reported = {m["name"] for m in end_to_end(manifest, w["name"])}
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{w['name']}: reports {sorted(reported)}")
        if not per_layer(manifest, w["name"]):
            out.append(f"{w['name']}: no per-layer metric")
    for m in manifest.get("per_layer", []):
        if m["moves"] not in e2e_names:
            out.append(f"{m['name']} moves unknown {m['moves']}")
        for cell_name in m.get("workloads", []):
            if m["moves"] not in {e["name"] for e in end_to_end(manifest, cell_name)}:
                out.append(f"{m['name']}: {cell_name} does not report {m['moves']}")
        if not os.path.isfile(reader_path(m["name"])):
            out.append(f"{m['name']}: no reader")
    pairs = [(w["config"], w["traffic"]) for w in manifest.get("workloads", [])]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    return out
