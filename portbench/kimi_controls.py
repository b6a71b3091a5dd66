"""Controls and planted faults of the ``train.kimi_linear_bank`` cell: what
its comparison has to reject.

    python -m portbench.kimi_controls --control <name> --seed <n> [<n> ...] [--seconds <s>]

Prints one JSON line a seed, all in one process, as ``portbench.bank_controls``
does: the control's name and the cell's compared numbers.  The benchmark's
own runs never run these.

* ``state_reset``: the KDA state zeroed before every 64th token (a chunked
  scan that drops the state it carries between chunks).
* ``head_gate``: one decay a head, the mean of its channels' log-decay (Gated
  DeltaNet's scalar gate in place of KDA's channel-wise one).
* ``no_conv``: the KDA layers without their short convolutions (identity taps).
* ``rope_in_mla``: the latent attention rotates ``q_pe`` and ``k_pe`` (RoPE at
  the published ``rope_theta``) where Kimi-Linear's is NoPE.
* ``bf16_state``: the KDA state rounded to bfloat16 after each token, the
  precision below the float32 state the layer states.
* ``all_experts``: the rows routed to experts this card does not hold are
  computed too, each with the weights of the held expert 128 below it (the
  card holds no others): the cut's absent share added back.
* ``no_shared``: the program without its shared expert.
* ``sound``: the program as it stands, for the lower readings.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import shutil
import sys

from .controls import _checks, _patched, context
from .run import run_cell

WORKLOAD = "train.kimi_linear_bank"


def _scan(ctx, **variant) -> dict:
    from mmgclip_tpu_torch.models import kimi_linear
    from mmgclip_tpu_torch.ops.kda import kda

    with _patched(kimi_linear, "kda_scan", functools.partial(kda, **variant)):
        return _checks(run_cell(ctx))


def state_reset(ctx) -> dict:
    return _scan(ctx, reset_every=64)


def head_gate(ctx) -> dict:
    return _scan(ctx, head_decay=True)


def bf16_state(ctx) -> dict:
    import torch

    return _scan(ctx, state_dtype=torch.bfloat16)


def no_conv(ctx) -> dict:
    import torch

    from mmgclip_tpu_torch.models import kimi_linear
    from mmgclip_tpu_torch.ops.kda import kda

    def identity_taps(q, k, v, f, beta, conv_q, conv_k, conv_v, *rest, **variant):
        taps = torch.zeros_like(conv_q)
        taps[:, -1] = 1.0
        return kda(q, k, v, f, beta, taps, taps, taps, *rest, **variant)

    with _patched(kimi_linear, "kda_scan", identity_taps):
        return _checks(run_cell(ctx))


def rope_in_mla(ctx) -> dict:
    from mmgclip_tpu_torch.models import kimi_linear
    from mmgclip_tpu_torch.models.deepseek_v3 import rope_tables

    def rotated(positions, c, device):
        return rope_tables(positions, c.qk_rope_head_dim, c.rope_theta, device)

    with _patched(kimi_linear, "mla_tables", rotated):
        return _checks(run_cell(ctx))


def all_experts(ctx) -> dict:
    from mmgclip_tpu_torch.models import deepseek_v3
    from mmgclip_tpu_torch.ops.moe_experts import dispatch

    def every_row(experts, n_experts, held=None):
        if held is not None:
            experts = held.start + (experts - held.start) % len(held)
        return dispatch(experts, n_experts, held)

    with _patched(deepseek_v3, "dispatch", every_row):
        return _checks(run_cell(ctx))


def no_shared(ctx) -> dict:
    ctx.config["control_overrides"] = ["networks.text_encoder.config.num_shared_experts=0"]
    return _checks(run_cell(ctx))


def sound(ctx) -> dict:
    return _checks(run_cell(ctx))


CONTROLS = {"state_reset": state_reset, "head_gate": head_gate, "no_conv": no_conv,
            "rope_in_mla": rope_in_mla, "bf16_state": bf16_state, "all_experts": all_experts,
            "no_shared": no_shared, "sound": sound}


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
        free_cached()
    return 0


def free_cached() -> None:
    """Give the last seed's cached blocks back: the next seed's 50 GB tower
    does not fit beside them."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
