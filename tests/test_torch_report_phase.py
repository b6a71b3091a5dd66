"""``chip_smoke.py`` phase 16 rehearsed on the CPU at a small size.

A tiny run is trained on the CPU; then the phase drives ``generate_report``
for one image and one four-view exam (Paeth-filtered PNGs), holding its
decisions and text equal to the serving engine's, ``evaluate_cnn`` (held
against itself on the CPU), and the unix-socket server with 32 concurrent
inline ``classify`` and 4 path ``report`` requests, each answered as
``handle`` answers it.  On the CPU every kernel takes its plain version, so
the phase expects no launch.
"""

import os

import torch

import chip_smoke
from mmgclip_tpu_torch.train import run


def test_report_phase_on_the_cpu(tmp_path):
    tree = chip_smoke.write_train_tree(str(tmp_path / "tree"), 40)
    run_dir = str(tmp_path / "run")
    run(chip_smoke.train_config(run_dir, tree, [
        "networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, "
        "num_attention_heads: 2, intermediate_size: 64}",
        "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
        "dataloader.test.batch_size=2", "scheduler.config.epochs=1"]), device="cpu")
    out = chip_smoke.phase_report_paths(torch.device("cpu"), str(tmp_path), run_dir, tree,
                                        shapes=((70, 52), (66, 50)),
                                        tower={**chip_smoke.REPORT_TOWER, "micro": True})
    assert os.path.isfile(os.path.join(out["report_dir"], "checkpoints", "model.msgpack"))
    assert len(out["views"]) == 4
    assert {"image", "exam", "evaluate_cnn", "serve_ms"} <= set(out["times"])
    assert set(out["times"]["serve_ms"]) == {"classify", "report"}
