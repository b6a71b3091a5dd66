"""The routed experts of a top-k MoE layer: rows sorted by expert on the
device (``dispatch``), then the grouped CUDA kernel (``csrc/moe_experts.cu``)
or its plain version.

``dispatch(experts [T, k], E)`` sorts the ``T * k`` (token, slot) rows by
expert with a stable sort and finds each expert's offsets and the
cumulative 128-row tiles the kernel's grid walks, all on the device: no count
is read back, so a layer can be captured.  ``moe_experts(x, plan, weights,
w_gate_up, w_down)`` -> float32 ``[T, D]``: for each token the sum, slot by
slot in a fixed order (so the result is deterministic), of
``weight * down_e(silu(gate_e(x)) * up_e(x))`` over its k experts.  The
arithmetic of both paths: float32 sums of bf16 operands, the SwiGLU rounded
to bf16, each weighted row rounded to bf16, the k rows summed in float32.

A layer that holds only some of the router's experts (expert parallelism:
the experts ``held``, a range of the router's ``E``, whose weights are the
stacks' rows in order) calls ``dispatch(experts, E, held)``: the rows routed
to experts it does not hold are sorted past the held ones and no tile
covers them, so their slots add nothing (their rows are zero) and nothing
is computed for them; ``plan.counts`` then counts the held experts' rows.

A CUDA tensor launches the kernel (launch count ``moe_experts``: one per
call, which launches the gate|up and the down GEMM); a CPU tensor runs
``plain_moe_experts`` (one float32 matmul per expert).  No gradient: the
tower is frozen.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
from torch.nn import functional as F

from . import count_launch
from ._build import check, load_typed

_SOURCE = "moe_experts.cu"
_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "mmg_moe_gate_up": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mmg_moe_down": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
TILE_ROWS = 128  # the kernel's BM


@dataclass
class Plan:
    """Rows sorted by expert: ``order`` [R] (the flat (token, slot) index of
    each sorted row), ``tokens`` [R] int32 (its token), ``offsets`` [E + 1]
    int32, ``tile_offsets`` [E + 1] int32 (cumulative ``TILE_ROWS`` tiles),
    ``counts`` [E] int64, over the ``E`` held experts; ``complete``: every
    row belongs to one of them."""
    order: torch.Tensor
    tokens: torch.Tensor
    offsets: torch.Tensor
    tile_offsets: torch.Tensor
    counts: torch.Tensor
    complete: bool = True


def dispatch(experts: torch.Tensor, n_experts: int, held: Optional[range] = None) -> Plan:
    """``experts`` [T, k] int64 of a router over ``n_experts`` -> the
    ``Plan`` over the experts ``held`` (default: all; no host read-back)."""
    k = experts.shape[1]
    flat = experts.reshape(-1)
    complete = held is None or (held.start == 0 and len(held) == n_experts)
    if not complete:
        if held.step != 1 or held.start < 0 or held.stop > n_experts or not len(held):
            raise ValueError(f"dispatch: held experts {held} of {n_experts}")
        flat = flat - held.start
        flat = flat.masked_fill((flat < 0) | (flat >= len(held)), len(held))  # past the held
        n_experts = len(held)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], bounds)
    counts = offsets[1:] - offsets[:-1]
    tiles = torch.cumsum((counts + TILE_ROWS - 1) // TILE_ROWS, 0)
    tile_offsets = torch.cat([tiles.new_zeros(1), tiles])
    return Plan(order=order, tokens=(order // k).to(torch.int32), offsets=offsets.to(torch.int32),
                tile_offsets=tile_offsets.to(torch.int32), counts=counts, complete=complete)


def _check(x, weights, w_gate_up, w_down) -> tuple:
    if x.dim() != 2 or w_gate_up.dim() != 3 or w_down.dim() != 3:
        raise ValueError("moe_experts takes x [T, D], w_gate_up [E, 2I, D], w_down [E, D, I]")
    E, two_i, D = w_gate_up.shape
    I = two_i // 2
    if x.shape[1] != D or tuple(w_down.shape) != (E, D, I) or two_i != 2 * I:
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, w_gate_up {tuple(w_gate_up.shape)}, "
                         f"w_down {tuple(w_down.shape)} do not fit")
    if weights.shape != (x.shape[0], weights.shape[1]):
        raise ValueError(f"weights {tuple(weights.shape)} for {x.shape[0]} tokens")
    return E, D, I


def _combine(rows: torch.Tensor, tokens: int, k: int) -> torch.Tensor:
    """[T * k, D] bf16 weighted rows in (token, slot) order -> float32 [T, D]."""
    return torch.sum(rows.view(tokens, k, rows.shape[1]), dim=1, dtype=torch.float32)


def plain_moe_experts(x: torch.Tensor, plan: Plan, weights: torch.Tensor,
                      w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, one float32 matmul per expert."""
    E, D, I = _check(x, weights, w_gate_up, w_down)
    T, k = weights.shape
    rows = torch.zeros(T * k, D, dtype=x.dtype, device=x.device)
    offsets = plan.offsets.tolist()
    flat_w = weights.reshape(-1).float()
    for e in range(E):
        sorted_rows = plan.order[offsets[e]:offsets[e + 1]]
        if not len(sorted_rows):
            continue
        xe = x[sorted_rows // k].float()
        gate_up = xe @ w_gate_up[e].float().T
        h = (F.silu(gate_up[:, :I]) * gate_up[:, I:]).to(x.dtype).float()
        out = (h @ w_down[e].float().T) * flat_w[sorted_rows, None]
        rows[sorted_rows] = out.to(x.dtype)
    return _combine(rows, T, k)


def launch_moe_experts(x: torch.Tensor, plan: Plan, weights: torch.Tensor,
                       w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Launch the two grouped GEMMs (CUDA tensors only; raises on any failure)."""
    if not (x.is_cuda and w_gate_up.is_cuda and w_down.is_cuda):
        raise ValueError("launch_moe_experts needs CUDA tensors")
    E, D, I = _check(x, weights, w_gate_up, w_down)
    if x.dtype != torch.bfloat16 or w_gate_up.dtype != torch.bfloat16 or w_down.dtype != torch.bfloat16:
        raise ValueError("launch_moe_experts takes bf16 activations and weights")
    if D % 8 or I % 8:
        raise ValueError(f"launch_moe_experts needs widths that are multiples of 8, got {D}, {I}")
    T, k = weights.shape
    R = T * k
    max_tiles = -(-R // TILE_ROWS) + E
    x, w_gate_up, w_down = x.contiguous(), w_gate_up.contiguous(), w_down.contiguous()
    h = torch.empty(R, I, dtype=x.dtype, device=x.device)
    # the slots of experts not held are never written: zero
    rows = (torch.empty if plan.complete else torch.zeros)(R, D, dtype=x.dtype, device=x.device)
    row_weights = weights.reshape(-1).float()[plan.order].contiguous()
    dest = plan.order.to(torch.int32)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_moe_gate_up(x.data_ptr(), plan.tokens.data_ptr(), w_gate_up.data_ptr(),
                                   plan.offsets.data_ptr(), plan.tile_offsets.data_ptr(),
                                   h.data_ptr(), E, D, I, max_tiles, stream)
        check(lib, code, "moe_experts (gate|up)")
        code = lib.mmg_moe_down(h.data_ptr(), w_down.data_ptr(), row_weights.data_ptr(),
                                dest.data_ptr(), plan.offsets.data_ptr(),
                                plan.tile_offsets.data_ptr(), rows.data_ptr(), E, D, I, R,
                                max_tiles, stream)
        check(lib, code, "moe_experts (down)")
    count_launch("moe_experts")
    return _combine(rows, T, k)


def moe_experts(x: torch.Tensor, plan: Plan, weights: torch.Tensor, w_gate_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighted sum per token.  CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    if x.is_cuda:
        return launch_moe_experts(x, plan, weights, w_gate_up, w_down)
    return plain_moe_experts(x, plan, weights, w_gate_up, w_down)
