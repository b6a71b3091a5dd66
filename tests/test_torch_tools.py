"""The port's host tools against the JAX scripts of ``tools/``.

* ``tools.eda``: ``analyse`` on ``tests/test_eda.py``'s frame (as rows)
  gives the JAX statistics, and ``eda.txt`` over its fixture tree is
  byte-equal to JAX's ``format_report(analyse(create_dataset_df(cfg)))``;
* ``tools.parity_harness``: stdout and exit code equal to the JAX script's,
  with and without ``--gate``, on the demo's ``results.json``, on results
  with a missing attribute, a NaN, a delta over 0.005 and every attribute
  at the reference;
* ``tools.make_vocab_fixture``: byte-equal to ``tests/data/vocab_fixture.txt``;
* ``tools.fixtures.build_image_label_tree``: every file byte-equal to
  ``tests/fixtures.py``'s (PNGs included) for the option sets the tools and
  tests use;
* ``tools.data_efficiency``: each fraction's ``.hydra/config.yaml`` byte-equal
  to the JAX tool's (its ``train.run`` stubbed), and a micro sweep of two
  fractions and one epoch on the CPU writes its rows and the CSV;
* ``tools.demo_run`` on the CPU writes the demo's artifact set (the
  committed ``MANIFEST.txt``) and refuses ``outputs/demo``.
"""

import csv
import io
import json
import os
import runpy
import sys
import types
from contextlib import redirect_stdout

import pandas as pd
import pytest
import torch

from fixtures import build_image_label_tree as jax_build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.data.ingest import create_dataset_df as jax_create_dataset_df
from mmgclip_tpu_torch.tools import data_efficiency, demo_run, eda, make_vocab_fixture, parity_harness
from mmgclip_tpu_torch.tools.fixtures import build_image_label_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_RUN = os.path.join(REPO, "outputs", "demo", "run")
sys.path.insert(0, os.path.join(REPO, "tools"))

import data_efficiency as jax_data_efficiency  # noqa: E402
from eda import analyse as jax_analyse  # noqa: E402
from eda import format_report as jax_format_report  # noqa: E402


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def eda_frame():
    return pd.DataFrame({
        "image_id": ["a", "b", "c", "d"],
        "image_label": [0, 1, 2, 0],
        "mass_margin": [[-1], ["spiculated"], ["obscured", "circumscribed"], [-1]],
        "mass_shape": [["oval"], ["irregular"], ["round", "oval"], [-1]],
        "has_mass": [True, True, True, False],
        "has_architectural_distortion": [False, True, False, False],
        "has_calc": [False, False, True, False],
        "image_path": ["p1", "p2", "p3", "p4"],
    })


def test_eda_statistics_match_jax_on_the_frame():
    frame = eda_frame()
    theirs = jax_analyse(frame)
    ours = eda.analyse(frame.to_dict("records"))
    assert ours == theirs
    assert list(ours["image_label_counts"]) == list(theirs["image_label_counts"])
    assert eda.format_report(ours) == jax_format_report(theirs)


def tree_overrides(base, annotated, lists_dir):
    return [f"dataset.config.base_dataset_path={base}",
            f"dataset.config.annotated_dataset_path={annotated}",
            f"dataset.config.lists_dataset_path={lists_dir}"]


def test_eda_txt_is_byte_equal_to_jax_on_the_tree(tmp_path):
    base, annotated, lists_dir, _ = jax_build_image_label_tree(
        str(tmp_path), n_benign=4, n_malignant=4, image_size=16, feature_store=False)
    overrides = tree_overrides(base, annotated, lists_dir)
    out = tmp_path / "eda_out"
    report = eda.main(["--out", str(out), *overrides])
    cfg = jax_compose(os.path.join(REPO, "configs"), "train_binary_class_clf", overrides=overrides)
    want = jax_format_report(jax_analyse(jax_create_dataset_df(cfg)))
    assert "images: 8" in report
    assert read_bytes(out / "eda.txt") == want.encode()
    assert (out / "margin_label_counts.png").exists() and (out / "shape_label_counts.png").exists()


def run_parity(main, argv):
    """-> (stdout, exit code) of a parity harness entry point."""
    buffer = io.StringIO()
    code = 0
    with redirect_stdout(buffer):
        try:
            main(argv)
        except SystemExit as exc:
            code = exc.code
    return buffer.getvalue(), code


def jax_parity_main(argv):
    saved = sys.argv
    sys.argv = ["parity_harness.py", *argv]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "parity_harness.py"), run_name="__main__")
    finally:
        sys.argv = saved


def parity_results(kind):
    with open(os.path.join(DEMO_RUN, "results", "results.json")) as fh:
        demo = json.load(fh)
    if kind == "demo":
        return demo
    reference = parity_harness.REFERENCE_AUC["image-prompts"]
    results = {name: {"zeroshot_label_prompt": {"auc_ci_mean": auc, "mean_auc": 0.5}}
               for name, auc in reference.items()}
    if kind == "missing":
        del results["MassShapeLabels"]
    elif kind == "nan":
        results["HasCalcification"]["zeroshot_label_prompt"]["auc_ci_mean"] = None
    elif kind == "delta":
        results["HasMassLabels"]["zeroshot_label_prompt"]["auc_ci_mean"] += 0.0062
    elif kind == "mean_auc":  # no CI mean: the macro mean, then the per-class AUCs
        results = {name: {"zeroshot_label_prompt": {"a": {"auc": auc + 0.001}, "b": {"auc": auc - 0.001}}}
                   for name, auc in reference.items()}
    return results


@pytest.mark.parametrize("kind", ["demo", "missing", "nan", "delta", "at_reference", "mean_auc"])
@pytest.mark.parametrize("flags", [[], ["--gate"], ["--gate", "--configuration", "exam-reports"]])
def test_parity_harness_prints_and_exits_as_jax(tmp_path, kind, flags):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(parity_results(kind)))
    argv = ["--results", str(path), *flags]
    ours = run_parity(parity_harness.main, argv)
    assert ours == run_parity(jax_parity_main, argv)
    assert ours[0].startswith("configuration: ")


def test_make_vocab_fixture_is_byte_equal(tmp_path):
    out = make_vocab_fixture.main(["--out", str(tmp_path / "vocab.txt")])
    assert read_bytes(out) == read_bytes(os.path.join(REPO, "tests", "data", "vocab_fixture.txt"))
    with pytest.raises(SystemExit):
        make_vocab_fixture.main([])


def tree_files(root):
    return {os.path.relpath(os.path.join(dp, f), root): read_bytes(os.path.join(dp, f))
            for dp, _dn, fn in os.walk(root) for f in fn}


@pytest.mark.parametrize("kwargs", [
    dict(n_benign=10, n_malignant=10, image_size=64, feature_store=False, pixel_class_signal=True),
    dict(n_benign=4, n_malignant=4, image_size=16, feature_store=False),
    dict(n_benign=6, n_malignant=5, separable=True),
])
def test_fixture_trees_are_byte_equal(tmp_path, kwargs):
    ours = build_image_label_tree(str(tmp_path / "port"), **kwargs)
    theirs = jax_build_image_label_tree(str(tmp_path / "jax"), **kwargs)
    assert [os.path.relpath(p, str(tmp_path / "port")) for p in ours] == \
        [os.path.relpath(p, str(tmp_path / "jax")) for p in theirs]
    port_files, jax_files = tree_files(str(tmp_path / "port")), tree_files(str(tmp_path / "jax"))
    assert sorted(port_files) == sorted(jax_files) and any(f.endswith(".png") for f in jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, name


def sweep_overrides(tree):
    base, annotated, lists_dir, features_dir = tree
    return [*tree_overrides(base, annotated, lists_dir),
            f"base.features_export_dir={features_dir}",
            "tokenizer.config.sequence_length=32", "scheduler.config.epochs=1",
            "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
            "dataloader.test.batch_size=2",
            "networks.text_encoder.config={vocab_size: 4096, hidden_size: 32, num_hidden_layers: 1, "
            "num_attention_heads: 2, intermediate_size: 64, max_position_embeddings: 64}"]


def test_data_efficiency_snapshots_and_micro_sweep(tmp_path, monkeypatch):
    tree = jax_build_image_label_tree(str(tmp_path / "tree"), n_benign=10, n_malignant=10,
                                      separable=True)
    overrides = sweep_overrides(tree)
    out = str(tmp_path / "sweep")

    def stub_run(cfg):  # the JAX sweep's snapshots, without training
        os.makedirs(cfg.base.results_export_dir, exist_ok=True)
        with open(os.path.join(cfg.base.results_export_dir, "results.json"), "w") as fh:
            json.dump({}, fh)

    monkeypatch.setitem(sys.modules, "train", types.SimpleNamespace(run=stub_run))
    jax_data_efficiency.run_sweep("train_binary_class_clf", [0.5, 1.0], out, overrides)
    snapshots = {tag: read_bytes(os.path.join(out, tag, ".hydra", "config.yaml"))
                 for tag in ("p50", "p100")}
    monkeypatch.delitem(sys.modules, "train")

    rows = data_efficiency.main(["--fractions", "0.5", "1.0", "--out", out, "--device", "cpu",
                                 *overrides])
    for tag, want in snapshots.items():
        assert read_bytes(os.path.join(out, tag, ".hydra", "config.yaml")) == want, tag
        assert os.path.isfile(os.path.join(out, tag, "results", "results.json"))
    assert sorted({row["fraction"] for row in rows}) == [0.5, 1.0]
    assert all(0.0 <= row["mean_auc"] <= 1.0 for row in rows)
    with open(os.path.join(out, "data_efficiency.csv")) as fh:
        read_back = list(csv.DictReader(fh))
    assert [float(r["fraction"]) for r in read_back] == [row["fraction"] for row in rows]
    assert os.path.isfile(os.path.join(out, "data_efficiency.png"))


def test_demo_run_writes_the_demo_artifact_set(tmp_path):
    run = demo_run.main(["--out", str(tmp_path / "demo"), "--device", "cpu"])
    assert read_bytes(os.path.join(run, "MANIFEST.txt")) == read_bytes(os.path.join(DEMO_RUN, "MANIFEST.txt"))
    with open(os.path.join(run, "results", "tsne", "tsne_coords.csv")) as fh:
        ours = [line.split(",", 2)[2] for line in fh.read().splitlines()]
    with open(os.path.join(DEMO_RUN, "results", "tsne", "tsne_coords.csv")) as fh:
        assert ours == [line.split(",", 2)[2] for line in fh.read().splitlines()]
    with pytest.raises(SystemExit, match="outputs/demo"):
        demo_run.main(["--out", os.path.join(REPO, "outputs", "demo"), "--device", "cpu"])


@pytest.mark.parametrize("tool,argv", [
    (data_efficiency, ["--fractions", "0.5"]),
    (demo_run, ["--out", "/nonexistent"]),
])
def test_tools_raise_without_a_card_unless_the_cpu_is_asked(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
