"""Report-bank sweeps through the Kimi-Linear text tower: ``sweeps.py``'s
traffic and comparison (its docstring) with the hybrid tower in the bank.

Set-up checks that the port has the tower (else it exits at once, before any
weight is drawn), draws the tower's weights on the card from the seed
(``data/kimi_linear.py``: every tensor by its HF name; of the routed experts
the configuration's ``experts_held``), builds one trainer whose tower is
built on ``meta`` and takes the drawn tensors over, and runs one sweep.  The
window runs whole sweeps of fresh rows until ``--seconds`` have passed:
``train_samples_per_s`` is the rows trained over the sweeps' wall time.

The comparison, after the window, against ``reference/kimi_linear.py`` (the
held share of the experts on both sides): ``feature_1mcos_max``,
``layer{i}_gap`` for each of ``check_layers`` (the layer's attention, KDA or
latent, and its MLP at the program's own inputs), ``hooked_pass_mismatch``,
``unbanked_rows``, ``head_loss_gap`` and ``batch_rows_mismatch``, as
``sweeps.py`` reads them; and ``layer{i}_scan_gap`` for each KDA layer of
``check_layers``: the scan's output (``models/kimi_linear.py::kda_scan``, the
kernel on the card) on the sampled rows of the hooked chunk against the
reference's token-by-token recurrence at the scan's own inputs, relative L2
over the rows' valid tokens.
"""

from __future__ import annotations

import time

import numpy as np

from ..data import kimi_linear as data
from . import common
from .sweeps import BANK_CHUNK, head_loss, hooked_chunk, observe_first_step, rel, sample_rows
from .train import _BankRows

PORT_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
             "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "num_shared_experts", "num_experts_per_token",
             "first_k_dense_replace", "routed_scaling_factor", "moe_renormalize", "rope_theta",
             "rms_norm_eps", "mla_use_nope")


def _flow(value) -> str:
    if isinstance(value, bool):
        return str(value).lower()
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{k}: {_flow(v)}" for k, v in value.items()) + "}"
    return str(value)


def tower_override(cj) -> str:
    """The tower's keys as one ``networks.text_encoder.config`` override: the
    router over ``router_experts``, holding ``experts_held``."""
    keys = {k: cj[k] for k in PORT_KEYS if k in cj}
    keys.update(num_experts=cj["router_experts"], experts_held=cj["experts_held"],
                linear_attn_config=cj["linear_attn_config"], dtype=cj["dtype"])
    return "networks.text_encoder.config=" + _flow(keys)


def run(ctx):
    try:
        from mmgclip_tpu_torch.models import kimi_linear  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"portbench: the port has no Kimi-Linear text tower: {exc}")
    import torch

    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.ops import launch_counts
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    from ..run import Check, Result

    tr, cj = ctx.traffic, ctx.config
    common.set_precision(cj)
    device = ctx.devices[0]
    bs, n_rows = int(tr["batch_size"]), int(tr["rows_per_sweep"])
    trainer_seed = ctx.seed % (1 << 31)
    with ctx.spans.span("setup.inputs"):
        ids = data.ZipfIds(ctx.seed, int(cj["vocab_size"]), float(tr["zipf_s"]))
    cfg = common.compose(cj, ctx.workdir, [
        tower_override(cj), f"tokenizer.config.sequence_length={int(tr['sequence_length'])}",
        f"base.seed={trainer_seed}", f"dataloader.train.batch_size={bs}",
        *cj.get("control_overrides", ())])

    def loader(sweep):
        input_ids, mask, features = data.sweep_rows(ctx.seed, sweep, tr, ids)
        rows = _BankRows(features, {"input_ids": input_ids, "attention_mask": mask})
        return DataLoader(rows, batch_size=bs, drop_last=True)

    unbanked = torch.zeros((), dtype=torch.long, device=device)

    def count_unbanked(exp):
        bank = exp._text_bank
        unbanked.add_((~torch.isfinite(bank).all(dim=1)).sum() + (n_rows - bank.shape[0]))

    with ctx.spans.span("setup.weights"):
        tree = data.tree(cj, ctx.seed, device)
    with ctx.spans.span("setup.first_sweep"):
        first = loader(0)
        exp = ClassifierExperiment(config=cfg, train_dataloader=first, device=device,
                                   text_weights=tree)
        del tree
        count_unbanked(exp)
        observer = observe_first_step(exp)
        exp.train()

    ctx.window_started()
    sweeps, traced, last = 0, None, first
    tracing = ctx.tracing
    with ctx.spans.span("window"):
        t0 = time.perf_counter()
        while True:
            if tracing and sweeps == 0:
                from mmgclip_tpu_torch.utils import profiling

                profiling.reset_spans()
                ctx.trace.start()
                before, lengths, t_traced = launch_counts(), [], time.perf_counter()
            with ctx.spans.span("sweep"):
                last = loader(sweeps + 1)
                exp.set_train_data(last)
                count_unbanked(exp)
                observer = observe_first_step(exp)
                exp.current_epoch += 1
                exp.train()
            sweeps += 1
            if tracing:
                lengths += last.dataset._tokens["attention_mask"].sum(axis=1).tolist()
            elapsed = time.perf_counter() - t0
            if tracing and (sweeps >= int(tr["trace_sweeps"]) or elapsed >= ctx.seconds):
                tracing = False
                after = launch_counts()
                traced = {"seconds": time.perf_counter() - t_traced, "lengths": lengths,
                          "launches": after["moe_experts"] - before["moe_experts"],
                          "kda_launches": after["kda"] - before["kda"], "sweeps": sweeps}
                ctx.trace.stop()
            if elapsed >= ctx.seconds:
                window_s = elapsed
                break
    samples = sweeps * (n_rows // bs) * bs
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    readings = dict(traced, tower=cj) if traced is not None else {}

    limits = tr["limits"]
    checks = [Check("unbanked_rows", float(unbanked.item()), 0.0)]
    checks += compare(ctx, exp, observer.finish(), last, trainer_seed)
    del exp
    for c in checks:
        c.limit = float(limits.get(c.name, c.limit))
    return Result(e2e={"train_samples_per_s": samples / window_s}, attempted=samples, failed=0,
                  memory_peak_bytes=peak, checks=checks, readings=readings)


def _scan_args(captured, r):
    """Row ``r`` of a captured scan call's arguments, at its valid length."""
    args = captured["args"]
    n = int(args[10][r])
    return [a[r, :n].float() for a in args[:5]] + [a.float() for a in args[5:10]], n


def compare(ctx, exp, observed, last, trainer_seed):
    """The compared numbers of the module docstring -> [Check] (limits from
    the traffic file)."""
    import torch

    from mmgclip_tpu_torch.models import kimi_linear

    from ..reference import precision
    from ..reference.kimi_linear import Weights, attention, is_kda, mlp, pooled, scan
    from ..run import Check
    from ..controls import _patched as patched

    tr, cj = ctx.traffic, ctx.config
    device = ctx.devices[0]
    tokens = last.dataset._tokens
    lengths = tokens["attention_mask"].sum(axis=1)
    first, rows = sample_rows(ctx.seed, lengths, int(tr["check_rows"]), BANK_CHUNK)
    width = int(lengths[rows].max())
    ids = torch.as_tensor(tokens["input_ids"][rows, :width], device=device)
    bank_rows = exp._text_bank[torch.as_tensor(rows, device=device)].double().cpu()
    layers = [int(i) for i in tr["check_layers"]]
    kda_order = [i for i in range(int(cj["num_hidden_layers"])) if is_kda(cj, i)]
    local = torch.as_tensor([r - first for r in rows], device=device)
    scans = []
    scan_fn = kimi_linear.kda_scan

    def keep_scan(*args, **kwargs):
        out = scan_fn(*args, **kwargs)
        if len(scans) in [kda_order.index(i) for i in layers if i in kda_order]:
            picked = [a[local] for a in args[:5]] + list(args[5:10]) + [args[10][local]]
            scans.append({"args": picked, "out": out[local]})
        else:
            scans.append(None)
        return out

    with patched(kimi_linear, "kda_scan", keep_scan):
        unequal, seen = hooked_chunk(exp, tokens, first, rows, layers, BANK_CHUNK)
    bs = int(tr["batch_size"])
    order = np.random.default_rng((trainer_seed, exp.current_epoch)).permutation(len(lengths))[:bs]
    step_rows = torch.as_tensor(order, device=device)
    text = exp._text_bank[step_rows].float()
    features = torch.as_tensor(last.dataset._features[order], device=device)
    start = {k: v.to(device) for k, v in observed["start"].items()}
    checks = [Check("hooked_pass_mismatch", unequal, 0.0),
              Check("batch_rows_mismatch",
                    float((np.asarray(observed["rows"][observed["first"]]) != order).sum()), 0.0)]
    weights = Weights(cj, ctx.seed, device)
    with precision(tf32=False), torch.no_grad():
        ref_loss = float(head_loss(start, features, text))
        checks.append(Check("head_loss_gap", abs(observed["loss"][0] - ref_loss) / abs(ref_loss),
                            0.0))
        ref = pooled(weights, [ids[r, :int(lengths[rows[r]])] for r in range(len(rows))])
        ref = ref.double().cpu()
        cos = (bank_rows * ref).sum(1) / (bank_rows.norm(dim=1) * ref.norm(dim=1))
        checks.append(Check("feature_1mcos_max", float((1 - cos).max()), 0.0))
        lens = [int(lengths[r]) for r in rows]
        for i in layers:
            w = weights.layer(i)
            h, out = seen[i]["attn"]
            want = torch.cat([attention(w, cj, i, x) for x in h.split(lens)])
            gap = rel(out, want)
            h, out = seen[i]["mlp"]
            want, margin = mlp(w, cj, i, h)
            keep = margin > float(tr["tie_margin"])
            checks.append(Check(f"layer{i}_gap", max(gap, rel(out[keep], want[keep])), 0.0))
            if i in kda_order:
                captured = scans[kda_order.index(i)]
                got, want = [], []
                for r in range(len(rows)):
                    args, n = _scan_args(captured, r)
                    got.append(captured["out"][r, :n].float())
                    want.append(scan(w, cj, *args[:5]).reshape(n, -1))
                checks.append(Check(f"layer{i}_scan_gap", rel(torch.cat(got), torch.cat(want)),
                                    0.0))
            del w
    return checks
