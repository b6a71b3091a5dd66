"""The port's bench (``mmgclip_tpu_torch/bench.py``) against the JAX bench
and the JAX package, on the CPU.

* ``_parse_hw`` equals ``bench._parse_hw`` over a set of inputs;
* the analytic cost model's matmul and elementwise FLOPs equal
  ``bench._convnext_layer_costs``'s row by row (and stage by stage where the
  JAX model prices a stage unfused because no Pallas band fits), plain,
  fused, int8 and both; bytes are the port's own kernels' and not compared;
* the report mode's decisions on its seeded inputs equal the JAX cascade's,
  and the text mode's prompt lengths and trimmed length equal those of the
  JAX tokenizer and ``trim_padded_tail``;
* with no card and no ``BENCH_PLATFORM=cpu`` every mode raises.

The six modes' CPU runs are in ``tests/test_torch_bench_modes.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.evaluation.report_cascade import run_cascade as jax_run_cascade
from mmgclip_tpu.evaluation.report_cascade import unpack_decisions as jax_unpack
from mmgclip_tpu.models.bert import trim_padded_tail as jax_trim
from mmgclip_tpu.prompts.generator import available_prompts_templates as jax_templates
from mmgclip_tpu_torch import bench
from mmgclip_tpu_torch.evaluation.report_cascade import BANK_ORDER
from mmgclip_tpu_torch.models.bert import trim_padded_tail


@pytest.mark.parametrize("value", ["256", "2294x1914", " 1024X832 ", 64, (64, 48), [7, 9], None,
                                   "96x80"])
def test_parse_hw_equals_jax(value):
    assert bench._parse_hw(value) == jax_bench._parse_hw(value)
    assert bench._parse_hw(value, default=128) == jax_bench._parse_hw(value, default=128)


def stage_sums(rows):
    sums = {}
    for name, mm, el, _bytes, q8 in rows:
        key = name.split("_")[0]
        m, e, q = sums.get(key, (0, 0, False))
        sums[key] = (m + mm, e + el, q or q8)
    return sums


@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"int8": True}, {"fused": True, "int8": True}],
                         ids=["plain", "fused", "int8", "fused_int8"])
@pytest.mark.parametrize("size", [64, 256, 512, (1024, 832), (2294, 1914)], ids=str)
def test_layer_flops_equal_jax(size, kw):
    ours = bench._convnext_layer_costs(size, batch=16, **kw)
    theirs = jax_bench._convnext_layer_costs(size, batch=16, **kw)
    by_name = {name: (mm, el, q8) for name, mm, el, _b, q8 in theirs}
    shared = [row for row in ours if row[0] in by_name]
    assert len(shared) >= 6, [row[0] for row in ours]
    for name, mm, el, _bytes, q8 in shared:
        assert (mm, el, q8) == by_name[name], name
    # a stage the JAX model prices unfused (no band fits) has the same sums
    assert stage_sums(ours) == stage_sums(theirs)
    assert all(b > 0 for name, _m, _e, b, _q in ours if not name.endswith("_vpu"))


def test_card_projection_accounts_for_the_whole_image():
    peaks = bench.PEAKS[bench.CARD]
    sol, stages = bench._card_per_layer_projection(256, peaks, fused=True, fuse_down=True,
                                                   batch=128, gelu_flops=8)
    measured, _ = bench._card_per_layer_projection(256, peaks, mm_tflops=400.0, fused=True,
                                                   fuse_down=True, batch=128, gelu_flops=8)
    assert 0 < measured <= sol
    assert sum(g["time_frac"] for g in stages.values()) == pytest.approx(1.0, abs=1e-3)
    assert {g["bound"] for g in stages.values()} <= {"tensor_cores", "fp32_cores", "hbm"}
    assert set(stages) >= {"stem", "stage0", "stage3", "down1"}


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_peaks_refuse_an_unknown_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    with pytest.raises(ValueError, match="no data-sheet peaks"):
        bench.peaks_for(torch.device("cuda", 0))
    assert bench.peaks_for(torch.device("cpu")) is bench.PEAKS[bench.CARD]


def test_report_decisions_equal_jax(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_ITERS", "2")
    monkeypatch.setenv("BENCH_MODE", "report")
    bench.main()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    table, mask, emb, _banks = bench.report_inputs()
    jax_decisions = jax_unpack(jax_run_cascade(jnp.asarray(emb), jnp.asarray(table),
                                               jnp.asarray(mask)))
    assert record["detail"]["decisions_sample"] == [jax_decisions[n] for n in BANK_ORDER]
    # the JAX bench draws the same inputs from the same seed
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(table, rng.normal(size=table.shape).astype(np.float32))


@pytest.mark.parametrize("seq", [32, 256])
def test_text_lengths_equal_jax(seq):
    sentences, enc = bench.prompt_bank_tokens(seq)
    jax_sentences = [s for bank in jax_templates().values() for sents in bank.values() for s in sents]
    assert sentences == jax_sentences
    jax_enc = JaxTokenizer.from_pretrained("emilyalsentzer/Bio_ClinicalBERT",
                                           sequence_length=seq)(jax_sentences, max_length=seq)
    np.testing.assert_array_equal(enc["attention_mask"].sum(1), jax_enc["attention_mask"].sum(1))
    batch = 256
    reps = int(np.ceil(batch / len(sentences)))
    ours = trim_padded_tail({k: np.tile(enc[k], (reps, 1))[:batch]
                             for k in ("input_ids", "attention_mask")}, 32)
    theirs = jax_trim({k: np.tile(jax_enc[k], (reps, 1))[:batch]
                       for k in ("input_ids", "attention_mask")}, multiple=32)
    assert ours["input_ids"].shape == theirs["input_ids"].shape
    np.testing.assert_array_equal(ours["attention_mask"], theirs["attention_mask"])


@pytest.mark.parametrize("mode", sorted(bench.MODES))
def test_no_card_and_no_request_raises(mode, monkeypatch, capsys):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setenv("BENCH_MODE", mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="BENCH_PLATFORM=cpu"):
        bench.main()
    assert capsys.readouterr().out == ""  # no record


def test_unknown_platform_and_mode_raise(monkeypatch):
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="BENCH_PLATFORM"):
        bench.bench_device()
    monkeypatch.setenv("BENCH_MODE", "nope")
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.main()
