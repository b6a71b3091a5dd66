"""``compare_runs`` and the plotting helpers of the port against the JAX
package's.

Two seeded runs of ``train_binary_class_clf`` (a one-layer, 32-wide BERT,
one and two epochs) trained in the port on the CPU, and a third run
directory holding a ``results.json`` of three attributes with a missing
value: the port's ``python -m mmgclip_tpu_torch.tools.compare_runs`` writes
``comparison.csv``, ``comparison.md`` and ``comparison.txt`` byte-equal to
``tools/compare_runs.py`` on the same directories, and its ROC overlay and
radar PNGs where matplotlib imports.  ``utils.plot`` writes each helper's
file here and, with matplotlib blocked, writes nothing and returns None.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke
from mmgclip_tpu_torch import __all__ as port_names
from mmgclip_tpu_torch.tools import compare_runs as port_compare
from mmgclip_tpu_torch.train import run
from mmgclip_tpu_torch.utils import plot
from mmgclip_tpu_torch.utils.tb import ScalarWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("comparison.csv", "comparison.md", "comparison.txt")


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_compare_runs",
                                                  os.path.join(REPO, "tools", "compare_runs.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("compare_runs")
    tree = chip_smoke.write_train_tree(str(root / "tree"), 12)
    dirs = []
    for name, epochs in (("one_epoch", 1), ("two_epochs", 2)):
        run_dir = str(root / name)
        run(chip_smoke.train_config(run_dir, tree, [
            "networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, "
            "num_attention_heads: 2, intermediate_size: 64}",
            "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
            "dataloader.test.batch_size=2", f"scheduler.config.epochs={epochs}"]), device="cpu")
        dirs.append(run_dir)
    made = root / "made_up" / "results"
    made.mkdir(parents=True)
    rng = np.random.default_rng(12)
    results = {key: {"zeroshot_label_prompt": {
        "auc_ci_mean": float(rng.uniform(0.5, 1.0)), "accuracy": float(rng.uniform()),
        "f1score": None if key == "MassShapeLabels" else float(rng.uniform()),
        "auc_ci_lower": 0.5, "auc_ci_higher": 1.0}}
        for key in ("BenignMalignantDatasetLabels", "MassShapeLabels", "BIRADS")}
    results["not_a_method"] = [1, 2]
    (made / "results.json").write_text(json.dumps(results))
    dirs.append(str(root / "made_up"))
    return root, dirs


@pytest.mark.parametrize("labels", [None, ["first", "second", "third"]])
def test_tables_are_byte_equal_to_the_jax_tool(run_dirs, labels, capsys):
    root, dirs = run_dirs
    tag = "default" if labels is None else "named"
    argv = dirs + (["--labels", *labels] if labels else [])
    ours = port_compare.main(argv + ["--out", str(root / f"port_{tag}")])
    jax_tool().compare_runs(dirs, labels=labels, out_dir=str(root / f"jax_{tag}"))
    for name in OUTPUTS:
        mine = (root / f"port_{tag}" / name).read_bytes()
        assert mine == (root / f"jax_{tag}" / name).read_bytes(), name
        assert mine.strip()
    assert ours["labels"] == (labels or ["one_epoch", "two_epochs", "made_up"])
    assert [row[0] for row in ours["tables"]["auc"].rows] == [
        "BenignMalignantDatasetLabels", "MassShapeLabels", "BIRADS"]
    # the overlays and the radar where matplotlib imports (it does here)
    assert ours["roc_overlays"] and all(os.path.isfile(p) for p in ours["roc_overlays"])
    assert ours["radar"] is None  # two of three runs hold one attribute: no complete axes


def test_runs_resolve_from_each_accepted_path(run_dirs):
    root, dirs = run_dirs
    paths = [dirs[0], os.path.join(dirs[1], "results"),
             os.path.join(dirs[2], "results", "results.json")]
    for path in paths:
        ours, theirs = port_compare.load_run(path), jax_tool().load_run(path)
        assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    with pytest.raises(FileNotFoundError):
        port_compare.load_run(str(root / "nowhere"))
    with pytest.raises(ValueError):
        port_compare.compare_runs(dirs, labels=["one"], out_dir=str(root / "bad"))


def test_radar_chart_with_three_complete_attributes(run_dirs):
    root, dirs = run_dirs
    out = port_compare.compare_runs([dirs[2], dirs[2]], out_dir=str(root / "radar"))
    assert out["labels"] == ["made_up#0", "made_up#1"]
    assert out["radar"] is not None and os.path.isfile(out["radar"])


def test_plot_helpers_write_their_files(tmp_path):
    assert {"plot_dataloader_batch", "plot_cv2_image", "pprint"} <= set(port_names)
    images = torch.rand(5, 16, 16)
    batch = {"image_features": images, "image_description": [f"view {i}" for i in range(5)]}
    plot.plot_dataloader_batch(batch, save_path=str(tmp_path / "batch.png"))
    plot.plot_dataloader_batch({"image_features": np.ones((3, 768))}, save_path=str(tmp_path / "bars.png"))
    plot.plot_cv2_image(images[0], save_path=str(tmp_path / "image.png"))
    writer = ScalarWriter(str(tmp_path / "runs"))
    logits = torch.randn(4, 4)
    plot.plot_logits_tensorboard(logits, logits.T, writer=writer, suptitle="step 1",
                                 save_path=str(tmp_path / "logits.png"))
    writer.close()
    for name in ("batch.png", "bars.png", "image.png", "logits.png"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_plot_helpers_skip_without_matplotlib(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.modules["matplotlib"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from mmgclip_tpu_torch.utils import plot
        out = {str(tmp_path)!r}
        assert plot.plot_dataloader_batch({{"image_features": np.ones((2, 8, 8))}},
                                          save_path=out + "/a.png") is None
        assert plot.plot_cv2_image(np.ones((8, 8)), save_path=out + "/b.png") is None
        assert plot.plot_logits_tensorboard(np.eye(3), np.eye(3), save_path=out + "/c.png") is None
        plot.pprint({{"ok": [1, 2]}})
        from mmgclip_tpu_torch.tools.compare_runs import main
        print("OK")
    """)
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.splitlines()[-1] == "OK"
    assert "matplotlib unavailable" in result.stderr
    assert not list(tmp_path.iterdir())
