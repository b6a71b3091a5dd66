"""The ``train.kimi_linear_bank`` cell on the CPU: the costs of the KDA scan
and of the hybrid tower, its readers on synthetic spans and traces, its
reference's imports and weights, and a micro-size sweep (the tower at the
CPU tests' size, rows long enough to cross a 64-token chunk), sound and with
each control of ``portbench.kimi_controls`` planted."""

import builtins
import copy
import math
import subprocess
import sys

import pytest
import torch

from portbench import kimi_controls, manifest
from portbench.costs.deepseek_v3 import expert_call
from portbench.costs.kimi_linear import bank_flops, row_flops, scan_call, scan_flops, token_macs
from portbench.costs.peaks import peaks
from portbench.data import kimi_linear as data
from portbench.run import Context, load_reader, run_cell
from portbench.tests.micro import ROOT, cell_files
from portbench.trace import Spans

CELL = "train.kimi_linear_bank"
H100 = peaks("NVIDIA H100 80GB HBM3")
_BENCH, _CELL, CONFIG, TRAFFIC = cell_files(CELL)
# 3 KDA layers then 1 MLA, layer 0 dense, 16 experts of which 8 held, top-4
MICRO_KIMI = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
              "moe_intermediate_size": 32, "num_hidden_layers": 4, "num_attention_heads": 4,
              "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
              "router_experts": 16, "num_experts": 8, "experts_held": [0, 8],
              "num_shared_experts": 1, "num_experts_per_token": 4,
              "linear_attn_config": {"kda_layers": [1, 2, 3], "full_attn_layers": [4],
                                     "num_heads": 4, "head_dim": 16, "short_conv_kernel_size": 4}}


def micro(tmp_path, seconds: float = 0.5, seed: int = 2 ** 31 + 7) -> Context:
    """The cell at micro size on the CPU, with the file's limits."""
    config, traffic = copy.deepcopy(CONFIG), copy.deepcopy(TRAFFIC)
    config.update(MICRO_KIMI)
    traffic.update(rows_per_sweep=48, batch_size=8, sequence_length=160, check_rows=4,
                   check_layers=[0, 3], lengths={"median": 90, "sigma": 0.4, "min": 40, "max": 160})
    return Context(cell=_CELL, config=config, traffic=traffic, seed=seed, seconds=seconds,
                   tracing=False, workdir=str(tmp_path), device="cpu", spans=Spans())


def test_the_configuration_is_the_published_one_cut_as_stated():
    assert CONFIG["num_experts"] == 128 and CONFIG["router_experts"] == 256
    assert CONFIG["published_num_experts"] == 256 and CONFIG["experts_held"] == [0, 128]
    assert CONFIG["reduced"] == ["num_experts", "tokenizer"]
    assert data.parameter_count(CONFIG) == 25_190_065_024 == CONFIG["parameters"]
    assert CONFIG["weight_bytes"] == 2 * CONFIG["parameters"]
    assert manifest.problems(_BENCH, ROOT) == []


def test_weights_are_drawn_by_name():
    name = "model.layers.1.self_attn.A_log"
    a = data.draw(2 ** 33 + 1, name, (32,), CONFIG, "cpu")
    assert torch.equal(a, data.draw(2 ** 33 + 1, name, (32,), CONFIG, "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) <= math.log(16.0) + 1e-6
    dt = torch.nn.functional.softplus(data.draw(5, "model.layers.1.self_attn.dt_bias", (4096,),
                                                CONFIG, "cpu"))
    assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 0.101
    conv = data.draw(5, "model.layers.0.self_attn.q_conv1d.weight", (64, 1, 4), CONFIG, "cpu")
    assert float(conv.abs().max()) <= 0.5 and torch.equal(conv, conv.to(torch.bfloat16).float())
    assert not data.draw(5, "model.layers.0.self_attn.g_b_proj.bias", (8,), CONFIG, "cpu").any()
    tree = data.tree(dict(CONFIG, **MICRO_KIMI), 5, "cpu")
    assert tree["model.layers.0.self_attn.A_log"].dtype == torch.float32
    assert tree["model.layers.0.self_attn.q_proj.weight"].dtype == torch.bfloat16
    assert "model.layers.1.mlp.experts.7.up_proj.weight" in tree
    assert "model.layers.1.mlp.experts.8.up_proj.weight" not in tree  # not held
    assert tuple(tree["model.layers.1.mlp.gate.weight"].shape) == (16, 64)  # the whole router


def test_costs_from_shapes_and_counts():
    # ~3.98 GFLOP a token outside attention's scores and the scan (published widths)
    assert 2 * token_macs(CONFIG) == pytest.approx(3.984e9, rel=1e-3)
    # a chunk of n tokens and a head: 3 n d^2 + 2 n^2 d multiply-adds
    assert scan_flops(64, 1, 2) == 2.0 * (3 * 64 * 4 + 2 * 64 * 64 * 2)
    assert scan_flops(70, 2, 4) == 2.0 * 2 * ((3 * 64 * 16 + 2 * 64 * 64 * 4)
                                              + (3 * 6 * 16 + 2 * 6 * 6 * 4))
    assert scan_flops(0, 32, 128) == 0.0
    ops, nbytes = scan_call([100, 3], CONFIG)
    assert ops == scan_flops(100, 32, 128) + scan_flops(3, 32, 128)
    assert nbytes == 103 * 41_024  # q, k, v, f (32 x 128 bf16 each) and 32 beta read, o written
    per_pair = 32 * (128 + 64 + 128)
    assert row_flops(CONFIG, 3) == (2.0 * (3 * token_macs(CONFIG) + 7 * 6 * per_pair)
                                    + 20 * scan_flops(3, 32, 128))
    assert bank_flops(CONFIG, [1, 3]) == row_flops(CONFIG, 1) + row_flops(CONFIG, 3)


def _records():
    return [
        {"name": "bank.device", "start_ns": 0, "end_ns": 100, "parent": 2, "attrs": {}},
        {"name": "bank.device", "start_ns": 100, "end_ns": 300, "parent": 3, "attrs": {}},
        {"name": "kda.layer", "start_ns": 0, "end_ns": 30, "parent": 2, "attrs": {"layer": 0}},
        {"name": "kda.scan", "start_ns": 10, "end_ns": 20, "parent": 9, "attrs": {"layer": 0}},
        {"name": "kda.layer", "start_ns": 100, "end_ns": 150, "parent": 3, "attrs": {"layer": 0}},
        {"name": "moe.tokens_per_expert", "start_ns": 40, "end_ns": 40, "parent": 2,
         "attrs": {"counts": [[12, 0, 6]], "held": [0, 3]}},
        {"name": "moe.tokens_per_expert", "start_ns": 200, "end_ns": 200, "parent": 3,
         "attrs": {"counts": [[4, 4, 4]], "held": [0, 3]}},
    ]


TOWER = {"num_hidden_layers": 2, "first_k_dense_replace": 1, "hidden_size": 8,
         "moe_intermediate_size": 4, "num_experts_per_token": 2,
         "linear_attn_config": {"kda_layers": [1], "num_heads": 2, "head_dim": 4}}


@pytest.mark.parametrize("metric", ["kda.layer_share", "moe.expert_roofline.kimi"])
def test_span_readers_on_synthetic_spans(metric, monkeypatch):
    from mmgclip_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    read = load_reader(metric)
    kernel_s = {"void (anonymous namespace)::grouped_gemm_kernel<true>(...)": 1e-9,
                "void (anonymous namespace)::grouped_gemm_kernel<false>(...)": 1e-9, "other": 5.0}
    readings = {"trace": {"kernel_s": kernel_s, "window_s": 1.0, "busy_s": 0.5}, "peaks": H100,
                "launches": 2, "tower": TOWER}
    value = read(readings)
    if metric == "kda.layer_share":
        assert value == pytest.approx(100.0 * 80 / 300)
    else:
        bound = sum(max(o / H100["bf16"], b / H100["hbm_bytes"])
                    for o, b in (expert_call(c, 8, 4, 2) for c in ([12, 0, 6], [4, 4, 4])))
        assert value == pytest.approx(100.0 * bound / 2e-9)
        assert read(dict(readings, launches=3)) is None  # the counter disagrees
        # the Moonlight bank's counters carry no held range: not this metric's
        monkeypatch.setattr(profiling, "spans", lambda: [
            dict(r, attrs={"counts": r["attrs"]["counts"]}) for r in _records()
            if r["name"] == "moe.tokens_per_expert"])
        assert read(readings) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(readings) is None


def test_the_scan_roofline_on_a_synthetic_trace():
    read = load_reader("kda.scan_roofline")
    lengths = [100] * 256 + [7] * 44  # two bank chunks
    trace = {"kernel_s": {"void (anonymous namespace)::kda_kernel<128, false>(...)": 2e-3,
                          "other": 1.0}, "window_s": 1.0, "busy_s": 1.0}
    readings = {"trace": trace, "peaks": H100, "lengths": lengths, "kda_launches": 20 * 2,
                "tower": CONFIG}
    bound = 0.0
    for chunk in (lengths[:256], lengths[256:]):
        ops, nbytes = scan_call(chunk, CONFIG)
        bound += max(ops / H100["bf16"], nbytes / H100["hbm_bytes"])
    assert read(readings) == pytest.approx(100.0 * 20 * bound / 2e-3)
    assert read(dict(readings, kda_launches=39)) is None
    assert read(dict(readings, trace=dict(trace, kernel_s={"other": 1.0}))) is None
    assert read(dict(readings, lengths=[])) is None
    assert read({k: v for k, v in readings.items() if k != "kda_launches"}) is None
    assert read(dict(readings, peaks=None)) is None


def test_the_bank_mfu():
    read = load_reader("bank.mfu.kimi")
    value = read({"peaks": H100, "seconds": 2.0, "lengths": [100, 200], "tower": CONFIG})
    assert value == pytest.approx(100.0 * bank_flops(CONFIG, [100, 200]) / 2.0 / H100["bf16"])
    assert read({"peaks": H100}) is None and read({"peaks": None, "seconds": 1.0}) is None


def test_the_cell_exits_at_once_without_the_tower(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_tower(name, *args, **kwargs):
        if name == "mmgclip_tpu_torch.models" and args[2] and "kimi_linear" in args[2]:
            raise ImportError("no kimi_linear")
        return real(name, *args, **kwargs)

    drawn = []
    monkeypatch.setattr(builtins, "__import__", no_tower)
    monkeypatch.setattr(data, "tree", lambda *a: drawn.append(a))
    with pytest.raises(SystemExit, match="no Kimi-Linear text tower"):
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
                                               "layer0_gap", "layer3_gap", "layer0_scan_gap",
                                               "hooked_pass_mismatch"}


@pytest.mark.parametrize("control", sorted(set(kimi_controls.CONTROLS) - {"sound"}))
def test_each_control_fails_a_limit(control, tmp_path):
    ctx = micro(tmp_path)
    numbers = kimi_controls.CONTROLS[control](ctx)
    limits = ctx.traffic["limits"]
    assert any(value > limits.get(name, 0.0) for name, value in numbers.items()), numbers
    assert all(math.isfinite(v) for v in numbers.values())


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, portbench.reference.kimi_linear, portbench.data.kimi_linear, "
            "portbench.costs.kimi_linear; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mmgclip_tpu_torch', 'mmgclip_tpu', 'jax', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
