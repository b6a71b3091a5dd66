"""Symmetric dynamic int8 quantisation (port of mmgclip_tpu/ops/quant.py).

Activations take one scale per tensor (or per row, see ``axis``), weights one
scale per output channel; products accumulate exactly in int32 and are
dequantised by the product of the two scales.  ``torch.round`` rounds half
to even, like ``jnp.round``.

Plain PyTorch: the unfused int8 product is one the JAX package leaves to
XLA.  On the CPU it is an int32 matmul; on the card a float64 matmul of the
int8 values, which is exact (each product is at most 127², every partial sum
an integer below 2⁵³), so the int32 result is the same either way.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def int8_quantize(x: torch.Tensor, axis=None, eps: float = EPS):
    """-> (q int8, scale fp32 broadcastable to x).  ``axis``: the reduction
    axes of the scale (None = one scale for the whole tensor)."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=eps) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 ``a [..., k]`` and ``b [k, n]`` with exact int32
    accumulation."""
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def int8_dot(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` through int8: x [..., c] with one dynamic scale for the
    tensor, w [c, f] with one scale per output channel; -> [..., f] in
    ``out_dtype``."""
    xq, xs = int8_quantize(x)
    wq, ws = int8_quantize(w, axis=0)  # [1, f]
    acc = int8_matmul(xq, wq)
    return (acc.float() * (xs * ws)).to(out_dtype)
