"""``python -m mmgclip_tpu_torch.tools.reproduce --fixtures --device cpu``:
convert -> encode -> train -> test() -> report from synthesized torch
artifacts in the real file layouts (a torchvision-named ConvNeXt-Tiny
classifier state dict, an HF BERT snapshot), on the CPU.

* the JAX tool's own assertions (``tests/test_reproduce.py``): converted
  files, a feature store, a checkpoint and scalars, a generated report, the
  run snapshot;
* the converted files byte-equal to the JAX converters' on the same
  artifacts;
* the report's decisions and text equal to the JAX package's report step
  over the same run: the JAX model built from the run's snapshot (the same
  converted text tower), the port's checkpoint, the same stored features,
  the same seeded template draw;
* ``--out`` holding foreign files is refused, and a run of the tool is
  cleared and redone.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest

import generate_report as jax_generate_report
import mmgclip_tpu
from mmgclip_tpu.config import recompose as jax_recompose
from mmgclip_tpu.evaluation.report_cascade import decide as jax_decide
from mmgclip_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from mmgclip_tpu_torch.tools import reproduce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return reproduce.main(["--fixtures", "--out", str(tmp_path_factory.mktemp("rep") / "run"),
                           "--epochs", "2", "--device", "cpu"])


def test_reproduce_fixtures_end_to_end(run):
    assert os.path.isfile(os.path.join(run, "converted", "convnext_tiny_clf.npz"))
    assert os.path.isfile(os.path.join(run, "converted", "bert.msgpack"))
    feats = [f for _dp, _dn, fn in os.walk(os.path.join(run, "encoded")) for f in fn
             if f.endswith(".npy")]
    assert len(feats) == 20
    assert os.listdir(os.path.join(run, "checkpoints"))
    assert os.path.isfile(os.path.join(run, "runs", "scalars.jsonl"))
    with open(os.path.join(run, "results", "results.json")) as fh:
        assert json.load(fh)["BenignMalignantDatasetLabels"]
    with open(os.path.join(run, "generated_report.txt")) as fh:
        content = fh.read()
    assert "decisions:" in content and len(content.splitlines()) >= 3
    assert os.path.isfile(os.path.join(run, ".hydra", "config.yaml"))
    assert os.path.isfile(os.path.join(run, reproduce.MARKER))


def run_jax_tool(name, *argv):
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")
    finally:
        sys.argv = saved


def test_converted_files_are_byte_equal_to_the_jax_converters(run, tmp_path):
    artifacts = os.path.join(run, "artifacts")
    for script, source, name in (
            ("convert_convnext.py", os.path.join(artifacts, "classifier_convnext_tiny.pt"),
             "convnext_tiny_clf.npz"),
            ("convert_bert.py", os.path.join(artifacts, "hf_bert"), "bert.msgpack")):
        out = str(tmp_path / name)
        run_jax_tool(script, "--input", source, "--output", out)
        with open(out, "rb") as a, open(os.path.join(run, "converted", name), "rb") as b:
            assert a.read() == b.read(), name


def test_report_equals_the_jax_report_step_over_the_same_run(run):
    with open(os.path.join(run, "generated_report.txt")) as fh:
        lines = fh.read().splitlines()
    source = lines[0][len("source features: "):]
    ours = json.loads(lines[1][len("decisions: "):])

    cfg = jax_recompose(run)
    tokenizer = mmgclip_tpu.Tokenizer.from_pretrained(
        cfg.tokenizer.config.tokenizer_name, sequence_length=int(cfg.tokenizer.config.sequence_length))
    model = mmgclip_tpu.MMGCLIP(cfg, seed=int(cfg.base.seed), vocab_size=tokenizer.vocab_size)
    state = jax_load_checkpoint(os.path.join(run, "checkpoints", cfg.checkpoints.checkpoints_file_name),
                                model.trainable_params)
    feats = np.load(source).reshape(1, -1).astype(np.float32)
    theirs = jax_decide(model, state["params"], tokenizer, feats)
    assert ours == theirs
    text, _ = jax_generate_report.generate_report(
        theirs, rng=mmgclip_tpu.seeding(int(cfg.base.seed)).host, bug_compat=True)
    assert lines[3] == text


def test_out_is_cleared_only_when_the_tool_made_it(tmp_path):
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "keep.txt").write_text("x")
    with pytest.raises(SystemExit, match="refusing to clear"):
        reproduce.prepare_out(str(foreign))
    assert (foreign / "keep.txt").exists()
    ours = tmp_path / "ours"
    reproduce.prepare_out(str(ours))
    (ours / "stale.txt").write_text("x")
    reproduce.prepare_out(str(ours))
    assert sorted(os.listdir(ours)) == [reproduce.MARKER]


def test_reproduce_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reproduce.main(["--fixtures"])
