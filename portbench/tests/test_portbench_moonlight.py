"""The ``train.moonlight_bank`` cell on the CPU: its inputs from the seed,
the costs of the grouped expert kernel, its readers on synthetic spans, its
reference's imports, and a micro-size sweep (the tower at the CPU tests'
size), sound and with each control of ``portbench.bank_controls`` planted."""

import builtins
import copy
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import bank_controls
from portbench.costs.deepseek_v3 import bank_flops, expert_call, row_flops, token_macs
from portbench.costs.peaks import peaks
from portbench.data import deepseek_v3 as data
from portbench.run import Context, load_reader, run_cell
from portbench.tests.micro import ROOT, cell_files
from portbench.trace import Spans

CELL = "train.moonlight_bank"
SEEDS = (2 ** 31 + 11, 2 ** 33 + 5)
H100 = peaks("NVIDIA H100 80GB HBM3")
_BENCH, _CELL, CONFIG, TRAFFIC = cell_files(CELL)
# the tower at the CPU tests' size: 1 dense + 2 MoE layers, 8 experts, top-2
MICRO_MOE = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
             "moe_intermediate_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4,
             "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
             "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2}


def micro(tmp_path, seconds: float = 0.5, seed: int = 2 ** 31 + 7) -> Context:
    """The cell at micro size on the CPU, with the file's limits."""
    config, traffic = copy.deepcopy(CONFIG), copy.deepcopy(TRAFFIC)
    config.update(MICRO_MOE)
    traffic.update(rows_per_sweep=48, batch_size=8, sequence_length=32, check_rows=4,
                   check_layers=[0, 1], lengths={"median": 12, "sigma": 0.6, "min": 4, "max": 32})
    return Context(cell=_CELL, config=config, traffic=traffic, seed=seed, seconds=seconds,
                   tracing=False, workdir=str(tmp_path), device="cpu", spans=Spans())


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_rows_are_deterministic_distinct_and_shaped(seed):
    ids = data.ZipfIds(seed, CONFIG["vocab_size"], TRAFFIC["zipf_s"])
    a = data.sweep_rows(seed, 3, TRAFFIC, ids)
    b = data.sweep_rows(seed, 3, TRAFFIC, data.ZipfIds(seed, CONFIG["vocab_size"], TRAFFIC["zipf_s"]))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    other = data.sweep_rows(seed, 4, TRAFFIC, ids)
    assert not np.array_equal(a[0], other[0])
    input_ids, mask, features = a
    lengths = mask.sum(1)
    spec = TRAFFIC["lengths"]
    assert input_ids.shape == (1024, 512) and features.shape == (1024, 768)
    assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]
    assert 150 < np.median(lengths) < 215 and 0.02 < (lengths == 512).mean() < 0.07
    assert input_ids.max() < CONFIG["vocab_size"] and not input_ids[mask == 0].any()
    # Zipf: the most frequent id carries a large share, most ids are rare
    counts = np.bincount(input_ids[mask > 0], minlength=CONFIG["vocab_size"])
    assert counts.max() > 0.05 * counts.sum() and (counts > 0).mean() < 0.5


def test_weights_are_drawn_by_name_bf16_exact():
    t = dict(CONFIG, hidden_size=16)
    name = "model.layers.3.self_attn.o_proj.weight"
    a = data.draw(SEEDS[0], name, (4, 16), t, "cpu")
    assert torch.equal(a, data.draw(SEEDS[0], name, (4, 16), t, "cpu"))
    assert torch.equal(a, a.to(torch.bfloat16).float())
    assert not torch.equal(a, data.draw(SEEDS[1], name, (4, 16), t, "cpu"))
    assert not torch.equal(a, data.draw(SEEDS[0], name.replace("o_proj", "q_proj"), (4, 16), t, "cpu"))
    assert data.parameter_count(CONFIG) == 15_624_565_888 == CONFIG["parameters"]
    assert CONFIG["weight_bytes"] == 2 * CONFIG["parameters"]


def test_costs_from_shapes_and_counts():
    # 4.48 GFLOP a token outside attention (the configuration's published widths)
    assert 2 * token_macs(CONFIG) == pytest.approx(4.48e9, rel=0.01)
    per_pair = 16 * (128 + 64 + 128)
    assert row_flops(CONFIG, 1) == 2.0 * (token_macs(CONFIG) + 27 * per_pair)
    assert row_flops(CONFIG, 3) == 2.0 * (3 * token_macs(CONFIG) + 27 * 6 * per_pair)
    assert bank_flops(CONFIG, [1, 3]) == row_flops(CONFIG, 1) + row_flops(CONFIG, 3)
    ops, nbytes = expert_call([12, 0, 6], d_model=8, width=4, k=2)
    assert ops == 2.0 * 18 * 8 * 3 * 4
    assert nbytes == 9 * 8 * 2 + 18 * 4 + 2 * 3 * 4 * 8 * 2 + 2 * 18 * 4 * 2 + 18 * 8 + 18 * 8 * 2


def _records():
    return [
        {"name": "bank.chunk", "start_ns": 0, "end_ns": 100, "parent": 1,
         "attrs": {"rows": 2, "valid_tokens": 30, "computed_tokens": 100}},
        {"name": "bank.chunk", "start_ns": 100, "end_ns": 200, "parent": 1,
         "attrs": {"rows": 2, "valid_tokens": 50, "computed_tokens": 100}},
        {"name": "moe.route", "start_ns": 0, "end_ns": 10, "parent": 2, "attrs": {"layer": 0}},
        {"name": "moe.experts", "start_ns": 10, "end_ns": 40, "parent": 2, "attrs": {"layer": 0}},
        {"name": "moe.route", "start_ns": 100, "end_ns": 110, "parent": 3, "attrs": {"layer": 0}},
        {"name": "moe.experts", "start_ns": 110, "end_ns": 200, "parent": 3, "attrs": {"layer": 0}},
        {"name": "moe.tokens_per_expert", "start_ns": 40, "end_ns": 40, "parent": 2,
         "attrs": {"counts": [[12, 0, 6]]}},
        {"name": "moe.tokens_per_expert", "start_ns": 200, "end_ns": 200, "parent": 3,
         "attrs": {"counts": [[4, 4, 4]]}},
    ]


TOWER = {"num_hidden_layers": 2, "first_k_dense_replace": 1, "hidden_size": 8,
         "moe_intermediate_size": 4}


@pytest.mark.parametrize("metric", ["bank.pad_share", "moe.route_share", "moe.expert_roofline"])
def test_span_readers_on_synthetic_spans(metric, monkeypatch):
    from mmgclip_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    read = load_reader(metric)
    kernel_s = {"void (anonymous namespace)::grouped_gemm_kernel<true>(...)": 1e-9,
                "void (anonymous namespace)::grouped_gemm_kernel<false>(...)": 1e-9, "other": 5.0}
    readings = {"trace": {"kernel_s": kernel_s, "window_s": 1.0, "busy_s": 0.5}, "peaks": H100,
                "launches": 2, "tower": TOWER, "k": 2}
    value = read(readings)
    if metric == "bank.pad_share":
        assert value == pytest.approx(100.0 * 120 / 200)
    elif metric == "moe.route_share":
        assert value == pytest.approx(100.0 * 20 / 140)
    else:
        bound = sum(max(o / H100["bf16"], b / H100["hbm_bytes"])
                    for o, b in (expert_call(c, 8, 4, 2) for c in ([12, 0, 6], [4, 4, 4])))
        assert value == pytest.approx(100.0 * bound / 2e-9)
        assert read(dict(readings, launches=3)) is None  # the counter disagrees
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(readings) is None


def test_host_readers():
    trace = {"kernel_s": {"k": 1.0}, "window_s": 4.0, "busy_s": 3.0}
    assert load_reader("device.idle_share.bank")({"trace": trace}) == pytest.approx(25.0)
    mfu = load_reader("bank.mfu")({"peaks": H100, "seconds": 2.0, "lengths": [100, 200],
                                   "tower": CONFIG})
    assert mfu == pytest.approx(100.0 * bank_flops(CONFIG, [100, 200]) / 2.0 / H100["bf16"])
    assert load_reader("bank.mfu")({"peaks": H100}) is None


def test_the_cell_exits_at_once_without_the_tower(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_tower(name, *args, **kwargs):
        if name == "mmgclip_tpu_torch.models" and args[2] and "deepseek_v3" in args[2]:
            raise ImportError("no deepseek_v3")
        return real(name, *args, **kwargs)

    drawn = []
    monkeypatch.setattr(builtins, "__import__", no_tower)
    monkeypatch.setattr(data, "tree", lambda *a: drawn.append(a))
    with pytest.raises(SystemExit, match="no DeepSeek-V3 text tower"):
        run_cell(micro(tmp_path))
    assert not drawn


def test_a_sound_micro_sweep_is_correct(tmp_path):
    ctx = micro(tmp_path)
    result = run_cell(ctx)
    assert all(c.ok for c in result.checks), [(c.name, c.value, c.limit) for c in result.checks]
    assert result.attempted % 48 == 0 and result.attempted >= 48
    assert ctx.setup_s is not None and result.e2e["train_samples_per_s"] > 0
    assert {c.name for c in result.checks} == {"unbanked_rows", "batch_rows_mismatch",
                                               "head_loss_gap", "feature_1mcos_max",
                                               "layer0_gap", "layer1_gap",
                                               "hooked_pass_mismatch"}


def test_the_hooked_pass_must_be_the_timed_one(tmp_path, monkeypatch):
    """A bank the timed encode made otherwise than the hooked pass does (a
    nudge of 1e-6 relative, below every other limit) fails
    ``hooked_pass_mismatch``."""
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    bank_texts = ClassifierExperiment._bank_texts

    def nudged(self, loader):
        bank_texts(self, loader)
        self._text_bank = self._text_bank * (1 + 1e-6)

    monkeypatch.setattr(ClassifierExperiment, "_bank_texts", nudged)
    checks = {c.name: c for c in run_cell(micro(tmp_path)).checks}
    assert checks["hooked_pass_mismatch"].value > 0 and not checks["hooked_pass_mismatch"].ok
    assert all(c.ok for name, c in checks.items() if name != "hooked_pass_mismatch")


@pytest.mark.parametrize("control", ["fp8_experts", "top5", "no_shared", "bias_in_weights",
                                     "no_causal", "stale_bank"])
def test_each_control_fails_a_limit(control, tmp_path):
    ctx = micro(tmp_path)
    numbers = bank_controls.CONTROLS[control](ctx)
    limits = ctx.traffic["limits"]
    assert any(value > limits.get(name, 0.0) for name, value in numbers.items()), numbers
    assert all(math.isfinite(v) for v in numbers.values())


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, portbench.reference.deepseek_v3, portbench.data.deepseek_v3; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mmgclip_tpu_torch', 'mmgclip_tpu', 'jax', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
