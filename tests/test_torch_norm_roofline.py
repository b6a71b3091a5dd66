"""The benchmark's ``norm.roofline`` reader (``portbench/layer_metrics``) on
synthetic traces, against readings worked by hand: the RMSNorm kernel's
least bytes over the valid tokens of both tower families."""

import pytest

from portbench import manifest
from portbench.run import load_reader

PEAKS = {"bf16": 100.0, "hbm_bytes": 100.0}
KERNEL = "void (anonymous namespace)::rms_norm_kernel<9, false, __nv_bfloat16>(...)"
GATED = "void (anonymous namespace)::rms_norm_kernel<1, true, __nv_bfloat16>(...)"
# hidden 8, latent 4: a token moves 2 layers x 2 norms x 32 bytes, 2 kv_a norms x 16, the
# final 16 + 32 (float32 out): 208 bytes
DEEPSEEK = {"hidden_size": 8, "num_hidden_layers": 2, "kv_lora_rank": 4}
# 3 layers, one MLA: 3 x 2 x 32 + 16 + 2 gated KDA norms x 3 x 2 x 8 (o and r read, y
# written, 2 heads of 4) + 48 = 352 bytes
KIMI = {"hidden_size": 8, "num_hidden_layers": 3, "kv_lora_rank": 4,
        "linear_attn_config": {"full_attn_layers": [3], "kda_layers": [1, 2], "num_heads": 2,
                               "head_dim": 4}}


@pytest.mark.parametrize("tower,token_bytes", [(DEEPSEEK, 208), (KIMI, 352)])
def test_the_valid_tokens_bytes_over_the_kernels_time(tower, token_bytes):
    """Lengths 3 and 1: 4 valid tokens at 100 bytes a second, over twice
    that time in the kernel's launches (every instantiation of it): 50%."""
    reader = load_reader("norm.roofline")
    seconds = 2 * 4 * token_bytes / 100.0
    trace = {"kernel_s": {KERNEL: 0.75 * seconds, GATED: 0.25 * seconds,
                          "grouped_gemm_kernel<true>": 9.0}}
    got = reader({"trace": trace, "peaks": PEAKS, "lengths": [3, 1], "tower": tower})
    assert got == pytest.approx(50.0)


def test_nothing_without_the_kernel_or_the_run_readings():
    reader = load_reader("norm.roofline")
    assert reader({"trace": {"kernel_s": {"kda_kernel<false>": 1.0}}, "peaks": PEAKS,
                   "lengths": [3], "tower": DEEPSEEK}) is None
    assert reader({"trace": {"kernel_s": {KERNEL: 1.0}}, "peaks": PEAKS, "lengths": [],
                   "tower": DEEPSEEK}) is None
    assert reader({"trace": None, "peaks": PEAKS, "lengths": [3], "tower": DEEPSEEK}) is None
    assert reader({}) is None
    assert manifest.reader_path("norm.roofline").endswith("norm.roofline.py")
