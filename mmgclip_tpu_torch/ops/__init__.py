"""Ops of the port: plain PyTorch math and the hand-written CUDA kernels.

Each kernel wrapper adds one to its launch count where it launches its kernel
and nowhere else, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

from typing import Dict

import torch

_LAUNCHES: Dict[str, int] = {
    "fused_convnext_block": 0, "flash_attention": 0, "fused_convnext_block_int8": 0,
    "fused_stem": 0, "fused_ln_downsample": 0, "depthwise_conv7x7": 0,
}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


class _PlainGrad(torch.autograd.Function):
    """Forward launches a kernel; backward differentiates the kernel's plain
    version, as the JAX package's ``custom_vjp``s differentiate the lax math."""

    @staticmethod
    def forward(ctx, launch, plain, kwargs, *args):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*args)
        return launch(*args, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(t.is_floating_point()) for t in ctx.saved_tensors]
        diff = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.plain(*inputs, **ctx.kwargs), diff, grad,
                                             allow_unused=True))
        return (None, None, None, *[next(grads) if t.requires_grad else None for t in inputs])


def run_kernel(launch, plain, *args, **kwargs):
    """``launch(*args, **kwargs)``, differentiable through ``plain`` when a
    gradient is wanted.  Callers route CUDA tensors here and CPU tensors to
    ``plain`` itself."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _PlainGrad.apply(launch, plain, kwargs, *args)
    return launch(*args, **kwargs)
