"""BENCHMARK.json against the rules this harness can check on the CPU."""

import json
import os

import pytest

from portbench import manifest
from portbench.tests.micro import ROOT

BENCH = manifest.load(ROOT)


def test_manifest_has_no_problems():
    assert manifest.problems(BENCH, ROOT) == []


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_names_and_units(entry):
    assert manifest.NAME.match(entry["name"])
    assert manifest.UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_and_metrics_reported(cell):
    config = manifest.config_entry(BENCH, cell["config"])
    with open(os.path.join(ROOT, config["file"]), encoding="utf-8") as fh:
        assert json.load(fh)["name"] == cell["config"]
    with open(manifest.traffic_path(cell["traffic"]), encoding="utf-8") as fh:
        traffic = json.load(fh)
    assert os.path.isfile(os.path.join(ROOT, "portbench", "generators", traffic["generator"] + ".py"))
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.per_layer(BENCH, cell["name"])
    assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_listed_cell_reports_what_the_metric_moves(metric):
    for cell in metric.get("workloads", []):
        assert metric["moves"] in {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert os.path.isfile(manifest.reader_path(metric["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_list_their_cuts(config):
    with open(os.path.join(ROOT, config["file"]), encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["reduced"] == config["reduced"]
    assert all(key in data for key in config["reduced"])
    assert data["source"] == config["source"]


def test_problems_are_found():
    broken = json.loads(json.dumps(BENCH))
    broken["workloads"][0]["name"] = "has space"
    broken["end_to_end"][0]["unit"] = "images per second"
    broken["per_layer"][0]["moves"] = "nothing"
    found = manifest.problems(broken, ROOT)
    assert any("has space" in p for p in found)
    assert any("images per second" in p for p in found)
    assert any("moves unknown" in p for p in found)
