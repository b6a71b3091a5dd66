"""``chip_smoke.py`` phase 19 rehearsed on the CPU at a small size.

``train_binary_class_clf`` with ``networks=clip_resnet50_bert`` at micro
width (ResNet stages ``(1, 1, 1, 1)`` at width 8, the micro ConvNeXt
encoding the report's PNGs) and a one-layer, 32-wide BERT trains on the
smoke's seeded features (3 epochs, ``test()``); the stem and ``layer1`` -
``layer3`` stay bit-unchanged while ``layer4`` and the heads move; then
``evaluate_clip`` reproduces ``results.json``, ``generate_report`` runs
through the feature-store preset's knobs, ``serve --once`` answers a
``classify``, and the graphed-epoch check runs (eager against eager off
the card).  On the CPU every kernel takes its plain version, so the phase
expects no launch.
"""

import torch

import chip_smoke


def test_resnet_phase_on_the_cpu(tmp_path):
    tree = chip_smoke.write_train_tree(str(tmp_path / "tree"), 16)
    times = chip_smoke.phase_resnet(
        torch.device("cpu"), str(tmp_path), "cpu", tree, micro=True,
        text="{hidden_size: 32, num_hidden_layers: 1, num_attention_heads: 2, intermediate_size: 64}",
        shapes=((70, 52), (66, 50)),
        extra=["dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
               "dataloader.test.batch_size=2"])
    assert {"bank_s", "test_s", "step_ms", "run_s", "evaluate_s", "report_s", "serve_s",
            "graph"} <= set(times)
    assert not any(times["train_launches"].values())
