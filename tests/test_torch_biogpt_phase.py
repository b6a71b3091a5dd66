"""``chip_smoke.py`` phase 18 rehearsed on the CPU at a small size.

``train_binary_class_clf`` with ``networks=clip_convnext_biogpt
tokenizer=biogpt`` and a one-layer, 32-wide causal tower trains on the
smoke's seeded features (Moses+BPE text bank, 3 epochs, ``test()``); then
``evaluate_clip`` reproduces ``results.json``, ``generate_report`` runs
through the micro tower in the feature-store preset's knobs, and ``serve
--once`` answers a ``classify``.  On the CPU every kernel takes its plain
version, so the phase expects no launch.
"""

import torch

import chip_smoke


def test_biogpt_phase_on_the_cpu(tmp_path):
    tree = chip_smoke.write_train_tree(str(tmp_path / "tree"), 16)
    times = chip_smoke.phase_biogpt(
        torch.device("cpu"), str(tmp_path), "cpu", tree,
        text="{hidden_size: 32, num_hidden_layers: 1, num_attention_heads: 2, intermediate_size: 64}",
        shapes=((70, 52), (66, 50)), tower={**chip_smoke.REPORT_TOWER, "micro": True},
        extra=["dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
               "dataloader.test.batch_size=2"])
    assert {"bank_s", "test_s", "step_ms", "run_s", "evaluate_s", "report_s", "serve_s"} <= set(times)
