"""Report-bank sweeps: the trainer's frozen-tower text bank, sweep after
sweep, through a DeepSeek-V3-family tower at its published widths.

Set-up checks that the port has the tower (else it exits at once, before
any weight is drawn), draws the tower's weights on the card from the seed
(``data/deepseek_v3.py``: every tensor by its HF name, bfloat16), builds
ONE trainer (``ClassifierExperiment``) whose tower is built on ``meta`` and
takes the drawn tensors over as they load, so that the card holds one copy,
and runs one sweep (the nvcc build, the eager warm-up steps and the capture
of the heads' step).  A sweep draws a fresh set of ``rows_per_sweep`` report
rows and image features, distinct from every other sweep's
(``sweep_rows``: log-normal lengths, Zipf ids over the published
vocabulary), banks them through the trainer (``set_train_data`` ->
``_pool_tokens``: chunks of 256 rows at the bank's longest row) and trains
one fused epoch of the heads over that bank at ``batch_size``.  The window
runs whole sweeps until ``--seconds`` have passed: ``train_samples_per_s``
is the rows trained over the sweeps' wall time (host clock; each epoch ends
in a synchronize).

The comparison, after the window: ``check_rows`` rows of one bank chunk of
the last sweep (the chunk that holds the sweep's longest row: that row and
others of the chunk drawn from the seed) against the plain reference
(``reference/deepseek_v3.py``), which draws the weights again tensor by
tensor: ``feature_1mcos_max``, 1 - cosine of each row's bank feature (the
timed path's output) against the reference's pooled feature;
``layer{i}_gap`` for each of ``check_layers``, the program's attention and
MLP outputs against the reference's at the program's own inputs to them,
relative L2 over the sampled rows' valid tokens, the larger of the two
(tokens whose selection the reference finds within ``tie_margin`` of a tie
left out of the MLP's).  Those inputs and outputs come from the trainer's
bank encode run again over that whole chunk, at the shape the timed encode
gave it (256 rows at the sweep's width), with hooks that keep the sampled
rows' tokens; ``hooked_pass_mismatch`` counts the chunk's rows whose pooled
feature in that pass differs in any bit from the bank's, so the hooked pass
is the timed one.  ``unbanked_rows``, the rows of every sweep without a
finite bank row; ``head_loss_gap``, the heads' first step of the last sweep
against the reference's loss at the parameters the program held before it,
on the rows the trainer's documented order gives, over the current sweep's
bank; and ``batch_rows_mismatch``, that step's rows against that order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..data import deepseek_v3 as data
from . import common
from .train import _ObservedGraph, _Observer, _BankRows

BANK_CHUNK = 256  # the rows of a chunk of the trainer's bank encode (``_pool_tokens``)


def _tower_keys(cj) -> str:
    """The tower's published keys as one ``networks.text_encoder.config`` override."""
    from mmgclip_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    keys = [f.name for f in dataclasses.fields(DeepseekV3Config) if f.name in cj]
    return ", ".join(f"{k}: {str(cj[k]).lower() if isinstance(cj[k], bool) else cj[k]}"
                     for k in keys) + f", dtype: {cj['dtype']}"


def observe_first_step(exp) -> _Observer:
    """Watch the next step the trainer takes through its graph (or eagerly)."""
    observer = _Observer(exp, 1)
    if exp._graph is not None:
        exp._graph = _ObservedGraph(exp._graph, observer)
    return observer


def run(ctx):
    try:
        from mmgclip_tpu_torch.models import deepseek_v3  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"portbench: the port has no DeepSeek-V3 text tower: {exc}")
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
        "networks.text_encoder.config={" + _tower_keys(cj) + "}",
        f"tokenizer.config.sequence_length={int(tr['sequence_length'])}",
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
                launches, lengths, t_traced = launch_counts()["moe_experts"], [], time.perf_counter()
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
                traced = {"seconds": time.perf_counter() - t_traced, "lengths": lengths,
                          "launches": launch_counts()["moe_experts"] - launches, "sweeps": sweeps}
                ctx.trace.stop()
            if elapsed >= ctx.seconds:
                window_s = elapsed
                break
    samples = sweeps * (n_rows // bs) * bs
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    readings = {}
    if traced is not None:
        readings = dict(traced, tower=cj, k=int(cj["num_experts_per_tok"]))

    limits = tr["limits"]
    checks = [Check("unbanked_rows", float(unbanked.item()), 0.0)]
    checks += compare(ctx, exp, observer.finish(), last, trainer_seed)
    for c in checks:
        c.limit = float(limits.get(c.name, c.limit))
    return Result(e2e={"train_samples_per_s": samples / window_s}, attempted=samples, failed=0,
                  memory_peak_bytes=peak, checks=checks, readings=readings)


def sample_rows(seed: int, lengths: np.ndarray, count: int, chunk: int):
    """``count`` distinct rows of the bank chunk that holds a sweep's longest
    row: that row and others of the chunk drawn from the seed -> (the
    chunk's first row, the rows)."""
    longest = int(np.argmax(lengths))
    first = longest - longest % chunk
    size = min(chunk, len(lengths) - first)
    others = [first + i for i in common.sample(seed, size, count, 23) if first + i != longest]
    return first, [longest] + others[:count - 1]


def hooked_chunk(exp, tokens, first: int, rows, layers, chunk: int):
    """The trainer's bank encode (``_pool_tokens``) again over the chunk of
    ``tokens`` that starts at ``first``, as the timed encode ran it (a last
    chunk padded to ``chunk`` rows by its last row), with hooks on the
    attention and the MLP of ``layers`` -> (the chunk's rows whose pooled
    feature differs in any bit from ``exp._text_bank``'s, {layer: {"attn" |
    "mlp": (input, output)}}, float32 ``[valid tokens, D]`` of ``rows`` in
    order)."""
    import torch

    n = len(tokens["attention_mask"])
    piece = {k: np.asarray(v[first:first + chunk]) for k, v in tokens.items()}
    valid = len(piece["attention_mask"])
    if valid < chunk < n:
        piece = {k: np.concatenate([v, np.repeat(v[-1:], chunk - valid, axis=0)])
                 for k, v in piece.items()}
    local = [r - first for r in rows]
    picked = torch.as_tensor(local, device=exp.device)
    module = exp.model.text_module
    seen = {i: {} for i in layers}

    def keep(x):
        valid = torch.as_tensor(piece["attention_mask"][local, :x.shape[1]] > 0, device=x.device)
        return x[picked][valid].float()

    hooks = []
    for i in layers:
        for name, sub in (("attn", module.layers[i].self_attn), ("mlp", module.layers[i].mlp)):
            def hook(_mod, args, out, i=i, name=name):
                seen[i][name] = (keep(args[0]), keep(out))
            hooks.append(sub.register_forward_hook(hook))
    try:
        pooled = exp._pool_tokens(piece, chunk=chunk)[:valid]
    finally:
        for h in hooks:
            h.remove()
    banked = exp._text_bank[first:first + valid]
    return float((pooled != banked).any(dim=1).sum()), seen


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def head_loss(start, features, text):
    """The CLIP loss of the heads at ``start`` (``{dotted name: tensor}``)."""
    import torch

    from ..reference.clip import clip_loss, l2n

    def head(prefix, x):
        n = sum(1 for k in start if k.startswith(prefix) and k.endswith(".kernel"))
        for j in range(n):
            x = x @ start[f"{prefix}.layers_{j}.kernel"] + start[f"{prefix}.layers_{j}.bias"]
            if j < n - 1:
                x = torch.relu(x)
        return l2n(x)

    return clip_loss(head("image_projection", features), head("text_projection", text),
                     start["logit_scale"])


def compare(ctx, exp, observed, last, trainer_seed):
    """The compared numbers of the module docstring -> [Check] (limits from
    the traffic file)."""
    import torch

    from ..reference import precision
    from ..reference.deepseek_v3 import Weights, attention, mlp, pooled
    from ..run import Check

    tr, cj = ctx.traffic, ctx.config
    device = ctx.devices[0]
    tokens = last.dataset._tokens
    lengths = tokens["attention_mask"].sum(axis=1)
    first, rows = sample_rows(ctx.seed, lengths, int(tr["check_rows"]), BANK_CHUNK)
    width = int(lengths[rows].max())
    ids = torch.as_tensor(tokens["input_ids"][rows, :width], device=device)
    bank_rows = exp._text_bank[torch.as_tensor(rows, device=device)].double().cpu()
    layers = [int(i) for i in tr["check_layers"]]
    unequal, seen = hooked_chunk(exp, tokens, first, rows, layers, BANK_CHUNK)
    bs = int(tr["batch_size"])
    order = np.random.default_rng((trainer_seed, exp.current_epoch)).permutation(len(lengths))[:bs]
    step_rows = torch.as_tensor(order, device=device)
    text = exp._text_bank[step_rows].float()
    features = torch.as_tensor(last.dataset._features[order], device=device)
    start = {k: v.to(device) for k, v in observed["start"].items()}
    del exp
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
            want = torch.cat([attention(w, cj, x) for x in h.split(lens)])
            gap = rel(out, want)
            h, out = seen[i]["mlp"]
            want, margin = mlp(w, cj, i, h)
            keep = margin > float(tr["tie_margin"])
            checks.append(Check(f"layer{i}_gap", max(gap, rel(out[keep], want[keep])), 0.0))
            del w
    return checks
