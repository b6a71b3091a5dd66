"""Each mode of the port's bench (``python -m mmgclip_tpu_torch.bench``)
runs in the process on the CPU at ``tests/test_bench.py``'s tiny knobs
under ``BENCH_PLATFORM=cpu`` and prints one record: the five keys, a finite
positive ``value``, ``detail.device == "cpu"`` and the launches of the timed
program (none: on CPU tensors every kernel wrapper runs its plain version).  The mode's own
keys are checked for the quantities the card run reads."""

import json
import math

import pytest
import torch

from mmgclip_tpu_torch import bench
from mmgclip_tpu_torch.ops import launch_counts
from test_bench import TINY_ENV

MODE_KEYS = {
    "encode": ("median_img_per_sec", "compute_only_img_per_sec", "reference_shaped_img_per_sec",
               "h2d_true_img_per_sec", "h2d_pipeline_img_per_sec", "bound", "binding_img_per_sec",
               "analytic_flops_per_image_g", "analytic_bytes_per_image_mb",
               "matmul_roofline_tflops", "mfu_vs_matmul_roofline", "above_ceiling",
               "reference_shaped_images", "int8_min_feature_cosine",
               "fused_min_feature_cosine", "fused_int8_min_feature_cosine", "fused_launches",
               "fused_int8_launches", "card_fused_sol_img_per_sec", "card_fused_per_stage"),
    "train": ("fused_cached_bank_samples_per_sec", "with_bert_forward_samples_per_sec",
              "fused_step_device_ms", "epoch_losses", "epochs_timed", "bank_seconds",
              "capture_launches"),
    "report": ("one_call_ms", "stepwise_9_roundtrips_ms", "decisions_sample"),
    "text": ("flash_prompts", "plain_prompts", "sdpa_prompts", "flash_trimmed", "plain_trimmed",
             "trimmed_seq", "prompt_len_max", "headline_program", "launches_by_program"),
    "serve": ("concurrent_req_per_sec", "sequential_req_per_sec", "sequential_p50_ms",
              "concurrent_p90_ms", "report_p50_ms", "encode_p50_ms", "fresh_prompts_p50_ms",
              "session_launches"),
    "ingest": ("e2e_windows_img_per_sec", "chain_compute_img_per_sec", "resize_only_img_per_sec",
               "reference_shaped_img_per_sec", "reference_shaped_images", "chain_launches",
               "native_bytes_per_image_mb", "card_projection"),
}


def run_mode(mode, monkeypatch, capsys, extra=None):
    for key, value in {**TINY_ENV, "BENCH_MODE": mode, **(extra or {})}.items():
        monkeypatch.setenv(key, value)
    threads = torch.get_num_threads()
    # one thread: the test workers share the cores, and at these sizes a
    # thread pool per worker oversubscribes them (tens of times slower)
    torch.set_num_threads(1)
    try:
        bench.main()
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("mode", sorted(MODE_KEYS))
def test_mode_prints_one_record(mode, monkeypatch, capsys):
    record = run_mode(mode, monkeypatch, capsys)
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert math.isfinite(record["value"]) and record["value"] > 0
    assert math.isfinite(record["vs_baseline"]) and record["vs_baseline"] > 0
    detail = record["detail"]
    assert detail["device"] == "cpu"
    assert detail["launches"] == {} and not any(launch_counts().values())
    assert detail["vs_baseline_basis"]
    for key in MODE_KEYS[mode]:
        assert key in detail, key
    if mode == "encode":
        assert record["value"] == pytest.approx(detail["median_img_per_sec"], abs=1e-3)
        assert detail["fused_min_feature_cosine"] > 0.999
        assert detail["binding_img_per_sec"] == min(detail["headline_compute_only_img_per_sec"],
                                                    detail["h2d_pipeline_img_per_sec"])
        assert set(detail["above_ceiling"]) <= {"mfu_vs_matmul_roofline", "median_over_h2d_true",
                                                "median_over_binding"}
        assert detail["reference_shaped_images"] == bench.REF_MIN_IMAGES
        assert set(detail["analytic_bytes_per_image_mb"]) == {"unfused", "fused", "fused_int8"}
    if mode == "text":
        sentences, enc = bench.prompt_bank_tokens(detail["seq"])
        lens = enc["attention_mask"].sum(1)
        assert (detail["prompt_len_min"], detail["prompt_len_max"]) == (lens.min(), lens.max())
        assert detail["prompt_len_max"] <= detail["trimmed_seq"] <= detail["seq"]
        assert record["value"] == pytest.approx(
            max(detail["flash_trimmed"], detail["plain_trimmed"]), abs=1e-3)
        assert detail["headline_program"] in ("flash_trimmed", "plain_trimmed")
        assert set(detail["launches_by_program"]) == {
            f"{v}_{c}" for v in ("flash", "plain", "sdpa") for c in ("prompts", "full", "trimmed")}
    if mode == "serve":
        assert detail["tiny"] is True
        assert detail["sequential_p50_ms"] <= detail["sequential_p95_ms"]
        assert set(detail["session_launches"]) == {"sequential", "report", "encode",
                                                   "fresh_prompts", "concurrent"}
    if mode == "train":
        assert detail["cuda_graph"] is False and all(map(math.isfinite, detail["epoch_losses"]))
        # TINY_ENV: a bank of 64 rows in batches of 8, at least 4 steps timed
        assert (detail["steps_per_epoch"], detail["epochs_timed"]) == (8, 1)
        assert detail["fused_step_device_ms"] is None  # the trainer's CUDA events: card only


def test_ingest_prepool_sends_block_sums(monkeypatch, capsys):
    plain = run_mode("ingest", monkeypatch, capsys)
    pre = run_mode("ingest", monkeypatch, capsys, {"BENCH_HOST_PREPOOL": "4"})
    assert pre["detail"]["resample"]["host_prepool"] == 4
    ratio = plain["detail"]["native_bytes_per_image_mb"] / pre["detail"]["native_bytes_per_image_mb"]
    assert 7.0 < ratio <= 8.0  # 2 bytes per 16 px against 1 byte per px (+ ceil)
    assert pre["value"] > 0


def test_unknown_variant_is_refused(monkeypatch):
    monkeypatch.setenv("BENCH_VARIANTS", "fused_int8,fused_typo")
    with pytest.raises(SystemExit, match="fused_typo"):
        bench._selected_variants()
