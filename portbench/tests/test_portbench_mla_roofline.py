"""``attn.mla_roofline`` on synthetic traces, against a reading worked by hand."""

import importlib.util

import pytest

from portbench import manifest
from portbench.run import load_reader

# 2 heads, q/k 4 + 2 rope, v 4, 3 layers; peaks of 100 operations and 100 bytes a second
TOWER = {"num_attention_heads": 2, "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 4,
         "num_hidden_layers": 3}
PEAKS = {"bf16": 100.0, "hbm_bytes": 100.0}
KERNEL = "void (anonymous namespace)::mla_attention_kernel<128, 64, 128>(...)"


def value(*args):
    spec = importlib.util.spec_from_file_location("attn_mla_roofline",
                                                  manifest.reader_path("attn.mla_roofline"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.value(*args)


def test_each_chunk_takes_the_larger_of_its_two_bounds():
    """Chunk 1, 256 rows of 3 valid tokens: operations 256 x 2 x 2 x 6 x 10 =
    61,440 (614.4 s), bytes 256 x 3 x 2 x (12 + 16 + 2 + 8) = 58,368 (583.68
    s); chunk 2, one row of 1: 40 operations (0.4 s), 76 bytes (0.76 s).  A
    launch is one layer of one chunk: 3 x (614.4 + 0.76) = 1,845.48 s over
    3,690.96 s of the kernel = 50%; summing before the max would read 49.97%."""
    kernel_s = {KERNEL: 3690.96, "grouped_gemm_kernel<true>": 7.0}
    assert value(kernel_s, [3] * 256 + [1], TOWER, PEAKS) == pytest.approx(50.0)


def test_nothing_without_the_kernel():
    """One row of 3: 240 operations (2.4 s) over 228 bytes (2.28 s), 3 layers: 7.2 s."""
    reader = load_reader("attn.mla_roofline")
    assert value({"grouped_gemm_kernel<true>": 1.0}, [3, 1], TOWER, PEAKS) is None
    assert reader({"trace": {"kernel_s": {"grouped_gemm_kernel<false>": 1.0}}, "peaks": PEAKS,
                   "lengths": [3, 1], "tower": TOWER}) is None
    assert reader({"trace": {"kernel_s": {KERNEL: 14.4}}, "peaks": PEAKS, "lengths": [3],
                   "tower": TOWER}) == pytest.approx(50.0)
