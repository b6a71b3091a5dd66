"""Controls and a planted fault of the ``train.moonlight_bank`` cell: what
its comparison has to reject.

    python -m portbench.bank_controls --control <name> --seed <n> [<n> ...] [--seconds <s>]

Prints one JSON line a seed, all in one process, as ``portbench.controls``
does: the control's name and the cell's compared numbers.  The benchmark's
own runs never run these.

* ``fp8_experts``: the routed experts' weights rounded to fp8 e4m3 (a scale
  per output row, as fp8 inference keeps them), the precision below the
  tower's stated bfloat16, in the program's place.
* ``top5``: the program routes each token to 5 experts, not 6.
* ``no_shared``: the program without its shared experts.
* ``bias_in_weights``: the selection bias added to the routing weights too,
  not only to the selection.
* ``no_causal``: the tower's attention without its causal mask (the padding
  mask kept).
* ``stale_bank``: a fault planted in the trainer: the fused epoch keeps the
  first sweep's banks, so every later sweep trains on stale text rows.
* ``sound``: the program as it stands, for the lower readings.
* ``unit_residual``: the program as it stands on weights drawn at the
  published init throughout (``residual_scale`` 1, where the configuration
  scales the residual branches' output projections by 1 / sqrt(54)): a
  reading of what that choice does to the compared numbers, not a control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from .controls import _checks, _patched, context
from .run import run_cell

WORKLOAD = "train.moonlight_bank"


def fp8_experts(ctx) -> dict:
    import torch

    from mmgclip_tpu_torch.models import clip, deepseek_v3

    load = clip.load_deepseek_v3_weights

    @torch.no_grad()
    def rounded(module, *args, **kwargs):
        read = load(module, *args, **kwargs)
        for layer in module.layers:
            if isinstance(layer.mlp, deepseek_v3.MoE):
                for stack in (layer.mlp.w_gate_up, layer.mlp.w_down):
                    for e in range(stack.shape[0]):
                        w = stack[e].float()
                        scale = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-30) / 448.0
                        stack[e].copy_((w / scale).to(torch.float8_e4m3fn).float() * scale)
        return read

    with _patched(clip, "load_deepseek_v3_weights", rounded):
        return _checks(run_cell(ctx))


def _with_override(ctx, override: str) -> dict:
    ctx.config["control_overrides"] = [override]
    return _checks(run_cell(ctx))


def top5(ctx) -> dict:
    return _with_override(ctx, "networks.text_encoder.config.num_experts_per_tok=5")


def no_shared(ctx) -> dict:
    return _with_override(ctx, "networks.text_encoder.config.n_shared_experts=0")


def bias_in_weights(ctx) -> dict:
    import torch

    from mmgclip_tpu_torch.models.deepseek_v3 import MoE

    def route(self, x):
        c = self.c
        scores = torch.sigmoid(torch.nn.functional.linear(x.float(), self.gate.float()))
        biased = scores + self.e_score_correction_bias.float()
        chosen = torch.topk(biased, c.num_experts_per_tok, dim=-1).indices
        weights = biased.gather(1, chosen)
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        return chosen, weights * c.routed_scaling_factor

    with _patched(MoE, "route", route):
        return _checks(run_cell(ctx))


def no_causal(ctx) -> dict:
    from mmgclip_tpu_torch.models import deepseek_v3

    def keys_only(attention_mask):
        s = attention_mask.shape[1]
        return (attention_mask[:, None, None, :] > 0).expand(-1, 1, s, s)

    with _patched(deepseek_v3, "attention_masks", keys_only):
        return _checks(run_cell(ctx))


def stale_bank(ctx) -> dict:
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    build = ClassifierExperiment._build_fused_epoch

    def once(self):
        if getattr(self, "_feats_bank", None) is None:
            build(self)

    with _patched(ClassifierExperiment, "_build_fused_epoch", once):
        return _checks(run_cell(ctx))


def sound(ctx) -> dict:
    return _checks(run_cell(ctx))


def unit_residual(ctx) -> dict:
    ctx.config["residual_scale"] = 1.0
    return _checks(run_cell(ctx))


CONTROLS = {"fp8_experts": fp8_experts, "top5": top5, "no_shared": no_shared,
            "bias_in_weights": bias_in_weights, "no_causal": no_causal, "stale_bank": stale_bank,
            "sound": sound, "unit_residual": unit_residual}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--control", choices=sorted(CONTROLS), required=True)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    for seed in args.seed:
        ctx = context(WORKLOAD, seed, args.seconds)
        try:
            numbers = CONTROLS[args.control](ctx)
        finally:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
        print(json.dumps({"control": args.control, "workload": WORKLOAD, "seed": seed,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
