"""The port stands alone: no JAX, no ``mmgclip_tpu``, nothing the card's
machine lacks.

An AST check over every module of ``mmgclip_tpu_torch``, ``chip_smoke.py``,
``kernel_ab.py``, ``block_sweep.py`` and ``stem_sweep.py`` refuses imports of the JAX package and of packages that machine does not
have (scikit-learn and safetensors among them), and a subprocess with those packages blocked in ``sys.modules`` (and
matplotlib and tensorboard, which the evaluator and the scalar writer only
try) imports every port module (the tools and the parallel layer too), runs the port's t-SNE and
``tools.convert_bert`` from a ``model.safetensors`` snapshot, runs the micro serving path on the CPU,
trains, tests and re-evaluates a tiny run through the ``train`` and
``evaluate_clip`` entry points, compares the two result sets through
``tools.compare_runs`` (its PNGs skipped), runs the micro ResNet-50 model,
generates its report for one image through ``generate_report``, evaluates the tower's classifier head through
``evaluate_cnn``, answers a ping on the unix-socket server, and builds the
exam family's supervision (``StudyReportDataset`` over a CSV the port
writes, the report pipeline's ``post_process_translated_report``).
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mmgclip_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmgclip_tpu", "yaml", "msgpack", "PIL",
             "pandas", "nltk", "transformers", "sacremoses", "triton", "ninja", "sklearn",
             "safetensors")
BLOCKED = FORBIDDEN + ("matplotlib", "tensorboard")


def port_sources():
    paths = [os.path.join(REPO, name) for name in ("chip_smoke.py", "kernel_ab.py", "block_sweep.py",
                                                 "stem_sweep.py")]
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in paths)


@pytest.mark.parametrize("path", port_sources())
def test_no_forbidden_imports(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_port_runs_with_the_missing_packages_blocked(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of it now raises ImportError
        import importlib, json, os, pkgutil, base64
        sys.path.insert(0, {REPO!r})
        import mmgclip_tpu_torch
        walked = set()
        for info in pkgutil.walk_packages(mmgclip_tpu_torch.__path__, "mmgclip_tpu_torch."):
            importlib.import_module(info.name)
            walked.add(info.name)
        new = {{"mmgclip_tpu_torch.models.resnet", "mmgclip_tpu_torch.utils.plot",
               "mmgclip_tpu_torch.tools.compare_runs", "mmgclip_tpu_torch.utils.tsne",
               "mmgclip_tpu_torch.utils.safetensors_lite"}}
        new |= {{"mmgclip_tpu_torch.parallel." + name for name in (
            "mesh", "multihost", "collectives", "contrastive", "zero", "expert",
            "tensor_parallel", "pipeline")}} | {{"mmgclip_tpu_torch.ops.ring_attention"}}
        new |= {{"mmgclip_tpu_torch.tools." + name for name in (
            "convert_convnext", "convert_bert", "convert_biogpt", "fixtures", "reproduce",
            "tsne_eval", "data_efficiency", "eda", "parity_harness", "demo_run",
            "make_vocab_fixture")}}
        assert new <= walked, new - walked
        import numpy as np
        from mmgclip_tpu_torch.utils.tsne import tsne
        points = np.random.default_rng(0).normal(size=(30, 8))
        embedded = tsne(points, perplexity=5.0).embedding
        assert embedded.shape == (30, 2) and np.isfinite(embedded).all()
        from mmgclip_tpu_torch.tools import convert_bert
        from mmgclip_tpu_torch.tools.fixtures import bert_state_dict, write_hf_snapshot
        bert = {{"vocab_size": 40, "hidden_size": 16, "num_hidden_layers": 1,
                "num_attention_heads": 2, "intermediate_size": 32, "max_position_embeddings": 16}}
        snapshot = write_hf_snapshot(os.path.join({str(tmp_path)!r}, "snap"), bert,
                                     bert_state_dict(bert), "safetensors")
        convert_bert.main(["--input", snapshot, "--output",
                           os.path.join({str(tmp_path)!r}, "bert.msgpack"), "--device", "cpu"])
        import chip_smoke
        import numpy as np
        from mmgclip_tpu_torch.serving import InferenceEngine
        from mmgclip_tpu_torch.serve import handle
        run = os.path.join({REPO!r}, "outputs", "demo", "run")
        engine = InferenceEngine.from_experiment(run, device="cpu")
        png = os.path.join({str(tmp_path)!r}, "view.png")
        chip_smoke.write_png16(png, chip_smoke.synthetic_mammogram(64, 48, seed=0))
        feats = np.asarray(handle(engine, {{"op": "encode", "paths": [png]}})["features"], np.float32)
        assert feats.shape == (1, 768) and np.isfinite(feats).all()
        out = handle(engine, {{"op": "classify", "paths": [png], "class_list": ["a mass.", "no mass."]}})
        assert abs(sum(out["classes_similarities"][0]) - 1) < 1e-5
        b64 = base64.b64encode(feats.tobytes()).decode()
        report = handle(engine, {{"op": "report", "features_b64": b64}})["reports"]
        assert len(report) == 1 and report[0]
        engine.close()

        from mmgclip_tpu_torch.evaluate_clip import main as evaluate_main
        from mmgclip_tpu_torch.train import run
        tree = chip_smoke.write_train_tree(os.path.join({str(tmp_path)!r}, "tree"), 12)
        run_dir = os.path.join({str(tmp_path)!r}, "run")
        cfg = chip_smoke.train_config(run_dir, tree, [
            "networks.text_encoder.config={{hidden_size: 32, num_hidden_layers: 1, "
            "num_attention_heads: 2, intermediate_size: 64}}",
            "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
            "dataloader.test.batch_size=2", "scheduler.config.epochs=2"])
        run(cfg, device="cpu")
        evaluate_main(["--experiment_path", run_dir, "--run_name", "replay", "--device", "cpu"])
        results = [json.load(open(os.path.join(run_dir, name, "results.json")))
                   for name in ("results", "replay")]
        assert results[0] == results[1] and results[0]["BenignMalignantDatasetLabels"], results
        from mmgclip_tpu_torch.tools import compare_runs
        compared = compare_runs.main([run_dir, os.path.join(run_dir, "replay"), "--out",
                                      os.path.join({str(tmp_path)!r}, "comparison")])
        assert compared["roc_overlays"] == [] and compared["radar"] is None, compared
        assert sorted(os.listdir(os.path.join({str(tmp_path)!r}, "comparison"))) == [
            "comparison.csv", "comparison.md", "comparison.txt"]
        import torch
        from mmgclip_tpu_torch.config import compose
        from mmgclip_tpu_torch.models.clip import MMGCLIP
        resnet = MMGCLIP(compose(os.path.join({REPO!r}, "configs"), "train_binary_class_clf",
                                 ["networks=clip_resnet50_bert",
                                  "networks.image_encoder.config={{micro: true}}",
                                  "networks.text_encoder.config={{hidden_size: 32, "
                                  "num_hidden_layers: 1, num_attention_heads: 2, "
                                  "intermediate_size: 64}}"], run_dir=run_dir), vocab_size=64)
        with torch.no_grad():
            out = resnet({{"image_features": torch.ones(2, 768)}}, text_features=torch.ones(2, 32))
        assert out["logits_per_image"].shape == (2, 2)

        from mmgclip_tpu_torch import evaluate_cnn, generate_report
        decisions, text = generate_report.main(["--experiment_path", run_dir, "--image_id",
                                                "p0200000002cl", "--device", "cpu"])
        assert set(decisions) and text, (decisions, text)
        cnn_cfg = chip_smoke.train_config(os.path.join({str(tmp_path)!r}, "cnn"), tree,
                                          ["dataloader.test.batch_size=2"])
        table = evaluate_cnn.run(cnn_cfg, device="cpu")
        assert [row[0] for row in table.rows] == ["benign", "malignant"], table.rows

        import asyncio, socket, threading
        from mmgclip_tpu_torch.serve import serve_socket
        engine = InferenceEngine.from_experiment(run_dir, device="cpu")
        sock, ready, box = os.path.join({str(tmp_path)!r}, "s.sock"), threading.Event(), []
        loop = asyncio.new_event_loop()
        def serve():
            box.append(loop.create_task(serve_socket(engine, unix_path=sock, ready_event=ready)))
            try:
                loop.run_until_complete(box[0])
            except asyncio.CancelledError:
                pass
        thread = threading.Thread(target=serve)
        thread.start()
        assert ready.wait(60)
        conn = socket.socket(socket.AF_UNIX)
        conn.connect(sock)
        conn.sendall(b'{{"op": "ping", "id": 5}}\\n')
        assert json.loads(conn.makefile().readline()) == {{"id": 5, "result": {{"ok": True}}}}
        conn.close()
        loop.call_soon_threadsafe(box[0].cancel)
        thread.join(60)
        engine.close()
        from mmgclip_tpu_torch.config import Config
        from mmgclip_tpu_torch.data.csv_table import Table, write_csv
        from mmgclip_tpu_torch.data.datasets import StudyReportDataset
        from mmgclip_tpu_torch.data.reports import post_process_translated_report
        exam = os.path.join({str(tmp_path)!r}, "exam")
        os.makedirs(exam)
        labels = str({{"birads": "3", "masses": {{"shapes": "oval"}}}})
        rows = []
        for i in range(2):
            path = os.path.join(exam, f"{{i}}.npy")
            np.save(path, np.full(768, i, np.float32))
            rows.append({{"patient_id": f"0220000{{i}}", "study_id": "st02", "is_malig": str(i),
                         "labels": labels, "study_path": path, "image_impression": "Imp.",
                         "image_description": "BI-RADS 3: a mass."}})
        write_csv(os.path.join(exam, "final.csv"), Table.from_rows(rows))
        ds = StudyReportDataset(Config({{
            "base": {{"seed": 1, "export_dir": exam}},
            "dataset": {{"config": {{"final_reports_dataset_path": os.path.join(exam, "final.csv"),
                                    "gtr_prompt_generation": False}}}},
            "tokenizer": {{"config": {{"tokenizer_name": "bert-base-uncased", "sequence_length": 16}}}}}}))
        assert len(ds) == 2 and ds._tokens["input_ids"].shape == (2, 16), ds.rows
        post = post_process_translated_report(
            ds.final_reports_dataset, Config({{"dataset": {{"config": {{"base_dataset_path": exam}}}}}}))
        assert post.rows[0]["image_description"] == "BIRADS 3  a mass.", post.rows[0]
        blocked = [m for m in {BLOCKED!r} if sys.modules.get(m) is not None]
        assert not blocked, blocked
        print("OK")
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    assert result.stdout.strip().splitlines()[-1] == "OK"


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout


def test_kernel_ab_fails_without_cuda_and_builds_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "ab.json"
    result = subprocess.run([sys.executable, os.path.join(REPO, "kernel_ab.py"), "--parent",
                             str(tmp_path), "--out", str(out)],
                            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "CUDA is not available" in result.stdout
    assert not out.exists()


def test_block_sweep_fails_without_cuda_and_writes_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "sweep.json"
    result = subprocess.run([sys.executable, os.path.join(REPO, "block_sweep.py"), "--out", str(out)],
                            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "needs a CUDA card" in result.stderr
    assert not out.exists()


@pytest.mark.parametrize("module,argv", [
    ("train", []),
    ("evaluate_clip", ["--experiment_path", "/nonexistent", "--run_name", "x"]),
    ("encode_images", []),
    ("encode_studies", []),
    ("evaluate_cnn", []),
    ("generate_report", ["--experiment_path", "/nonexistent", "--image_id", "p0200000002cl"]),
    ("serve", ["--experiment_path", "/nonexistent", "--unix", "/nonexistent.sock"]),
])
def test_entry_points_raise_without_a_card_unless_the_cpu_is_asked(module, argv, monkeypatch):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = importlib.import_module(f"mmgclip_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main(argv)
