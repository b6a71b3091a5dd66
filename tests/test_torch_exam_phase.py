"""``chip_smoke.py`` phase 17 rehearsed on the CPU at a small size.

The micro tower (in the feature-store preset's knobs) encodes two studies of
four small views and one corrupt study through ``encode_studies``; the exam
family trains on the CPU with a tiny BERT under ``CLIPLoss`` and
``MMGCLIPLoss`` (the graph-vs-eager comparison runs eager on both sides
here); the reduced-width runs, ``ProjectionHead`` and ``moe512`` among them,
run twice on the CPU; ``PromptClassifier`` equals the serving engine's
``classify``.  On the CPU every kernel takes its plain version, so the phase
expects no launch.
"""

import torch

import chip_smoke


def test_exam_phase_on_the_cpu(tmp_path):
    times = chip_smoke.phase_exam(
        torch.device("cpu"), str(tmp_path), "cpu", shapes=((70, 52), (66, 50)),
        tower={**chip_smoke.REPORT_TOWER, "micro": True},
        text="{hidden_size: 32, num_hidden_layers: 1, num_attention_heads: 2, intermediate_size: 64}",
        n_studies=2, n_train=40, n_reduced=24, batch=8)
    assert {"encode_s", "encode_split", "graph", "train_clip_step_ms", "train_mmgclip_step_ms"} <= set(times)
    assert times["graph"]["bit_equal"] and times["graph"]["kernel_ms"] is None
