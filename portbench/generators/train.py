"""Training: the trainer's graphed epoch (``ClassifierExperiment.train``),
epoch after epoch as ``run()`` calls it, over a cached bank.

Set-up draws ``bank_rows`` stored image features and gives each row one of
the traffic's label prompts (equal counts, seeded order), tokenized with
the benchmark's WordPiece over its vocabulary file; writes the text tower's
weights; builds ONE trainer from the seed (the tower and heads through
``init_params``); and runs its first epoch, which caches the text bank,
takes the trainer's eager warm-up steps, captures the step as a CUDA graph
and replays it for the rest of the epoch.  The first ``check_steps`` steps
that go through the window's own call (a graph replay on the card; the
eager step where the trainer keeps no graph) are observed as they happen:
each step's loss, the optimizer's first moments before and after the first
of them (which give the gradient it got), and the trainable leaves before
the first and after the last.  Nothing in them is changed: the epoch's loss
total is set aside around each observed step and put back bit for bit.
The window runs whole epochs until ``--seconds`` have passed:
``train_samples_per_s`` is their samples over their wall time (host clock;
each epoch ends in a synchronize).  Afterwards the plain reference steps
from the same initial weights on the same rows, whose order it draws
itself, through the last observed step, and the numbers the comparison
needs are compared.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np

from ..data import weights
from ..data.vocab import write_vocab
from . import common


class _BankRows:
    """What a label dataset hands the trainer's fused epoch: ``_features``
    ``[n, D]`` and ``_tokens``."""

    def __init__(self, features, tokens):
        self._features, self._tokens = features, tokens

    def __len__(self) -> int:
        return len(self._features)


def bank(seed: int, rows: int, dim: int, texts, tokenizer, length: int):
    """-> (features [rows, dim] float32, text index per row, the distinct
    texts' tokens)."""
    rng = np.random.default_rng([int(seed), 3])
    features = rng.normal(size=(rows, dim)).astype(np.float32)
    text_index = rng.permutation(np.arange(rows) % len(texts))
    return features, text_index, tokenizer(list(texts), length)


def tower_trees(config, seed: int, device: str):
    """The ResNet tower and the heads from the seed, float32."""
    tower, heads = config["image_tower"], config["heads"]
    maker = weights.resnet_tree(tower["stage_sizes"], tower["width"], prefix="image_encoder.")
    weights.heads_tree(tower["width"] * 32, config["text_tower"]["hidden_size"],
                       heads["projection_dim"], maker)
    values, _file = maker.make(weights.tree_seed(seed, "resnet"), device)
    values["logit_scale"] = np.asarray(math.log(1.0 / heads["logit_temperature"]), np.float32)
    return values


class _Observer:
    """Watches the trainer's steps as they are taken, without changing them:
    the rows of each, up to the last it reads, and the first ``count`` that
    go through the window's own call (a replay of the captured graph on the
    card, else the eager step).  Its hooks come off the trainer once it has
    read them; ``finish()`` returns what it read, on the host."""

    def __init__(self, exp, count: int):
        self.exp, self.count = exp, count
        self.out = {"rows": [], "loss": [], "first": None}
        self._saved = None
        exp._bank_step = self._bank_step
        exp._capture_step = self._capture_step

    def _watching(self) -> bool:
        return len(self.out["loss"]) < self.count

    def _observed_step(self, idx, take) -> None:
        exp, out = self.exp, self.out
        trainable = [k for k in exp.params if exp.optimizer.trainable[k]]
        out["rows"].append(idx.clone())
        if out["first"] is None:
            out["first"] = len(out["rows"]) - 1
            out["start"] = {k: exp.params[k].detach().clone() for k in trainable}
            out["mu_before"] = {k: exp.optimizer.mu[k].clone() for k in trainable}
        # the step adds its loss to the epoch's total: set the total aside,
        # read the loss alone, and put it back (float addition commutes, so
        # the total is the step's own to the bit)
        self._saved = exp._epoch_total.clone()
        exp._epoch_total.zero_()
        take()
        out["loss"].append(exp._epoch_total.clone())
        exp._epoch_total.add_(self._saved)
        if len(out["loss"]) == 1:
            out["mu_after"] = {k: exp.optimizer.mu[k].clone() for k in trainable}
        if len(out["loss"]) == self.count:
            out["end"] = {k: exp.params[k].detach().clone() for k in trainable}
            self._unhook()

    def _bank_step(self, idx) -> None:
        import torch

        exp = self.exp
        step = type(exp)._bank_step
        if exp.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            step(exp, idx)
        elif exp.use_cuda_graph:  # an eager warm-up step before the capture
            self.out["rows"].append(idx.clone())
            step(exp, idx)
        else:
            self._observed_step(idx, lambda: step(exp, idx))

    def _capture_step(self, bs: int) -> None:
        type(self.exp)._capture_step(self.exp, bs)
        self.exp._graph = _ObservedGraph(self.exp._graph, self)

    def _unhook(self) -> None:
        exp = self.exp
        for name in ("_bank_step", "_capture_step"):
            exp.__dict__.pop(name, None)
        if isinstance(exp._graph, _ObservedGraph):
            exp._graph = exp._graph.graph

    def finish(self) -> dict:
        self._unhook()
        out = self.out
        out["rows"] = [r.cpu().numpy() for r in out["rows"]]
        out["loss"] = [float(v) for v in out["loss"]]
        for key in ("start", "end", "mu_before", "mu_after"):
            if key in out:
                out[key] = {k: v.cpu() for k, v in out[key].items()}
        return out


class _ObservedGraph:
    """The captured step, with the observer around its first replays."""

    def __init__(self, graph, observer: _Observer):
        self.graph, self.observer = graph, observer

    def replay(self) -> None:
        exp = self.observer.exp
        self.observer._observed_step(exp._graph_idx, self.graph.replay)


def run(ctx):
    import torch

    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    from ..reference.text import WordPiece
    from ..run import Check, Result

    tr, cj = ctx.traffic, ctx.config
    common.set_precision(cj)
    device = ctx.devices[0]
    text = cj["text_tower"]
    trainer_seed = ctx.seed % (1 << 31)
    with ctx.spans.span("setup.inputs"):
        vocab = write_vocab(os.path.join(ctx.workdir, "vocab.txt"), tr["texts"], text["vocab_size"])
        features, text_index, enc = bank(ctx.seed, int(tr["bank_rows"]), int(tr["feature_dim"]),
                                         tr["texts"], WordPiece(vocab), text["sequence_length"])
        tokens = {k: v[text_index] for k, v in enc.items()}
    with ctx.spans.span("setup.weights"):
        bert_file = os.path.join(ctx.workdir, "bert.npz")
        bert_tree = common.bert_weights(cj, ctx.seed, device, bert_file)
        init = tower_trees(cj, ctx.seed, device)
    cfg = common.compose(cj, ctx.workdir, common.text_overrides(cj, vocab, bert_file)
                         + [f"base.seed={trainer_seed}",
                            f"dataloader.train.batch_size={int(tr['batch_size'])}"])
    bs = int(tr["batch_size"])
    loader = DataLoader(_BankRows(features, tokens), batch_size=bs, drop_last=True)
    exp = ClassifierExperiment(config=cfg, train_dataloader=loader, device=device,
                               init_params=init)

    observer = _Observer(exp, int(tr["check_steps"]))
    with ctx.spans.span("setup.first_epoch"):
        exp.train()
    observed = observer.finish()

    ctx.window_started()
    epochs, traced = 0, None
    tracing = ctx.tracing
    with ctx.spans.span("window"):
        t0 = time.perf_counter()
        while True:
            if tracing and epochs == 0:
                ctx.trace.start()
                first_ms = len(exp.timings["epoch_device_ms"])
            exp.current_epoch += 1
            with ctx.spans.span("train.epoch"):
                exp.train()
            epochs += 1
            elapsed = time.perf_counter() - t0
            if tracing and (epochs >= int(tr["trace_epochs"]) or elapsed >= ctx.seconds):
                tracing = False
                traced = {"epochs": epochs, "seconds": elapsed,
                          "device_ms": list(exp.timings["epoch_device_ms"][first_ms:]),
                          "steps": list(exp.timings["epoch_steps"][first_ms:])}
                ctx.trace.stop()
            if elapsed >= ctx.seconds:
                window_s = elapsed
                break
    steps_per_epoch = len(features) // bs
    samples = epochs * steps_per_epoch * bs
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    readings = {}
    if traced is not None:
        readings = {"samples": traced["epochs"] * steps_per_epoch * bs,
                    "seconds": traced["seconds"], "epoch_device_ms": traced["device_ms"],
                    "epoch_steps": traced["steps"], "batch_size": bs,
                    "tf32": bool(torch.backends.cudnn.allow_tf32),
                    "stage_sizes": cj["image_tower"]["stage_sizes"],
                    "feature_dim": int(tr["feature_dim"]),
                    "text_dim": text["hidden_size"],
                    "projection_dim": cj["heads"]["projection_dim"]}
    trainable_port = sorted(k for k in exp.params if exp.optimizer.trainable[k])
    del exp, observer, loader
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    limits = tr["limits"]
    checks = [Check("steps_unobserved", float(int(tr["check_steps"]) - len(observed["loss"])), 0.0)]
    if checks[0].ok:
        ref = reference_steps(cj, tr, features, text_index, enc, bert_tree, init,
                              observed["first"], len(observed["loss"]), trainer_seed, device,
                              at_start=observed["start"])
        observed["grad"] = first_gradient(observed)
        gaps = compare(observed, ref, trainable_port)
        checks += [Check(name, value, limits.get(name, 0.0)) for name, value in gaps.items()]
    return Result(e2e={"train_samples_per_s": samples / window_s}, attempted=samples, failed=0,
                  memory_peak_bytes=peak, checks=checks, readings=readings)


def first_gradient(observed) -> dict:
    """The gradient the optimizer got at the first observed step, from its
    first moments before and after it: ``mu' = (1 - b1) g + b1 mu``."""
    from ..reference.clip import B1

    before, after = observed["mu_before"], observed["mu_after"]
    return {n: (after[n].double() - B1 * before[n].double()) / (1 - B1) for n in after}


def reference_steps(cj, tr, features, text_index, enc, bert_tree, init, first, count,
                    trainer_seed, device, tf32: bool = False, at_start=None) -> dict:
    """The plain reference's steps from the initial weights through step
    ``first + count - 1``, on the rows the trainer's documented order gives
    (numpy ``default_rng((seed, 0)).permutation``) -> {rows, loss (every
    step's), grad (at step ``first``), start (the trainable leaves before
    step ``first``), end (after the last)}, and with ``at_start`` (trainable
    leaves: the program's before step ``first``) also grad_at_start, the
    gradient at those leaves on that step's rows.  ``tf32``: computed one
    precision below float32 (the control)."""
    import torch

    from ..reference import precision
    from ..reference.clip import AdamW, clip_loss, l2n
    from ..reference.resnet import ResNet50
    from ..reference.text import Bert

    bs = int(tr["batch_size"])
    order = np.random.default_rng((trainer_seed, 0)).permutation(len(features))
    steps = first + count
    rows = [order[k * bs:(k + 1) * bs] for k in range(steps)]
    with precision(tf32=tf32):
        pooled = Bert(bert_tree, device).pooled(enc["input_ids"], enc["attention_mask"])
        tower = ResNet50(init["image_encoder"], device, cj["image_tower"]["stage_sizes"])

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).clone().requires_grad_()

        def host(tree):
            return {k: v.detach().cpu().clone() for k, v in tree.items()}

        params = {f"image_encoder.{k}": v for k, v in tower.trainable().items()}
        for head in ("image_projection", "text_projection"):
            params[f"{head}.layer.kernel"] = t(init[head]["layer"]["kernel"])
        params["logit_scale"] = t(init["logit_scale"])
        def loss_and_grads(k):
            feats = torch.as_tensor(features[rows[k]], device=device)
            text = pooled[torch.as_tensor(text_index[rows[k]], device=device)]
            image_emb = l2n(tower(feats) @ params["image_projection.layer.kernel"])
            text_emb = l2n(text @ params["text_projection.layer.kernel"])
            loss = clip_loss(image_emb, text_emb, params["logit_scale"])
            return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

        opt = AdamW(params, cj["optimizer"]["learning_rate"], cj["optimizer"]["weight_decay"])
        losses = []
        for k in range(steps):
            if k == first:
                start = host(params)
            loss, grads = loss_and_grads(k)
            if k == first:
                grad = host(grads)
            opt.step(grads)
            losses.append(float(loss.detach()))
        out = {"rows": rows, "loss": losses, "grad": grad, "start": start, "end": host(params)}
        if at_start is not None:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(at_start[name].to(device))
            out["grad_at_start"] = host(loss_and_grads(first)[1])
    return out


def compare(observed, ref, trainable_port) -> dict:
    """The compared numbers: the rows of every step through the last
    observed one, the trainable set, each observed step's loss (relative
    gap, worst step), the gradient at the first observed step and the
    change of the leaves over the observed steps (each by the worst leaf:
    the gap of the norms over the larger of the reference leaf's and the
    median leaf's norm; the change leaves out leaves whose reference
    gradient is under a thousandth of the median leaf's, which move by
    round-off alone); and the projection heads' gradient at the first
    observed step against the reference's at the trainable leaves the
    program held then (the norm of the difference over both heads, over the
    reference's norm), which neither the earlier steps' round-off nor a
    ReLU of the tower flipping under it can move.  ``observed`` holds ``rows``, ``first``, ``loss`` (the
    observed steps'), ``grad``, ``start`` and ``end``."""
    first = observed["first"]
    out = {"batch_rows_mismatch": float(sum(
        int((np.asarray(observed["rows"][k]) != ref["rows"][k]).sum())
        for k in range(len(ref["rows"]))))}
    out["trainable_set_mismatch"] = float(len(set(ref["start"]) ^ set(trainable_port)))
    out["loss_gap_max"] = max(abs(float(loss) - ref["loss"][first + k]) / abs(ref["loss"][first + k])
                              for k, loss in enumerate(observed["loss"]))
    names = sorted(set(ref["start"]) & set(trainable_port))
    g_ref = {n: float(ref["grad"][n].double().norm()) for n in names}
    g_med = float(np.median(list(g_ref.values())))
    g_port = {n: float(observed["grad"][n].double().norm()) for n in names}
    out["grad_norm_gap_max"] = max(abs(g_port[n] - g_ref[n]) / max(g_ref[n], g_med) for n in names)
    moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]

    def change(side, n):
        return float((side["end"][n].double() - side["start"][n].double()).norm())

    d_ref = {n: change(ref, n) for n in moved}
    d_port = {n: change(observed, n) for n in moved}
    d_med = float(np.median(list(d_ref.values())))
    out["change_norm_gap_max"] = max(abs(d_port[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved)
    heads = [n for n in names if n.startswith(("image_projection.", "text_projection."))]
    diff = sum(float((observed["grad"][n].double() - ref["grad_at_start"][n].double()).square().sum())
               for n in heads)
    scale = sum(float(ref["grad_at_start"][n].double().square().sum()) for n in heads)
    out["head_grad_diff_at_state"] = math.sqrt(diff / scale)
    return out
