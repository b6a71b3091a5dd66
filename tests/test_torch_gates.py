"""The product-gate phase of ``chip_smoke.py`` (phase 15), rehearsed on the CPU.

On the card the phase encodes a feature store per speed knob of the tower
through the CUDA kernels (``tests/test_torch_cuda.py`` runs it there); on
the CPU every knob takes its kernel's plain version, so these tests hold
what the phase is made of: its fixture tree equals ``tests/fixtures.py``'s
(the JAX gate's, written there with PIL), and the whole phase runs end to
end, its baseline learning the planted signal (best AUC >= 0.9).
"""

import json
import os

import numpy as np
import torch

import chip_smoke
from fixtures import build_image_label_tree
from mmgclip_tpu_torch.ingest.png_reader import decode_png


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_gate_tree_equals_the_jax_fixture(tmp_path):
    ours = chip_smoke.write_gate_tree(str(tmp_path / "ours"))
    theirs = build_image_label_tree(str(tmp_path / "theirs"), n_benign=16, n_malignant=16,
                                    image_size=32, feature_store=False, pixel_class_signal=True)[:3]
    for a, b in zip(ours, theirs):
        assert _files(a) == _files(b)
        for name in _files(a):
            pa, pb = os.path.join(a, name), os.path.join(b, name)
            if name.endswith(".png"):
                np.testing.assert_array_equal(decode_png(pa), decode_png(pb), err_msg=name)
            elif name.endswith(".json"):
                assert json.load(open(pa)) == json.load(open(pb)), name
            else:
                assert open(pa).read() == open(pb).read(), name


def test_product_gates_run_on_the_cpu(tmp_path):
    aucs = chip_smoke.phase_product_gates(torch.device("cpu"), str(tmp_path))
    assert set(aucs) == {"baseline", *chip_smoke.GATE_VARIANTS}
    assert max(aucs["baseline"].values()) >= chip_smoke.GATE_MIN_AUC
    for tag in ("fused", "fused_tanh", "fused_tanh_glue", "use_pallas_dwconv"):
        assert set(aucs[tag]) == set(aucs["baseline"])
