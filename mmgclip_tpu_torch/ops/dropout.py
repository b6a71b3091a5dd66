"""JAX's dropout masks on any device: threefry keys and flax's ``nn.Dropout``.

A port-only kernel (no Pallas counterpart: XLA fuses JAX's threefry).  On a
CUDA tensor the wrappers launch ``csrc/threefry_dropout.cu``:
``mmg_threefry2x32`` for ``split`` and ``fold_in`` (one launch each) and
``mmg_dropout`` for the whole draw (fold-in of the Dropout's scope constant,
bits, uniform, compare, select) in one pass.  On a CPU tensor they run the
plain version, ``utils/prng.py``.  Keys stay on the device, so a step that
splits its key and draws its masks reads nothing back and can be captured in
a CUDA graph.  The backward is ``select(mask, g / keep, 0)``, the VJP of
flax's ``lax.select(mask, x / keep, 0)``, with ``keep`` a tensor on the
gradient's device (true division on either device: a CPU scalar divisor
would be a multiply by its reciprocal on the card).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import prng
from . import count_launch
from ._build import check, load_typed

_SOURCE = "threefry_dropout.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _U, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    "mmg_threefry2x32": [_P, _LL, _LL, _P, _P],
    "mmg_dropout": [_I, _P, _P, _U, _F, _LL, _P, _P, _P],
}


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"a key is an int64 tensor of shape (2,), got {key.dtype} {tuple(key.shape)}")


def launch_threefry2x32(key: torch.Tensor, base: int, n: int) -> torch.Tensor:
    """The hash of the counters ``base .. base + n - 1`` under ``key`` ->
    int64 [n, 2] (CUDA tensors only; raises on any failure)."""
    if not key.is_cuda:
        raise ValueError("launch_threefry2x32 needs CUDA tensors")
    _check_key(key)
    if n <= 0 or base < 0:
        raise ValueError(f"threefry2x32 takes n > 0 counters from base >= 0, got n {n}, base {base}")
    key = key.contiguous()
    out = torch.empty((n, 2), dtype=torch.int64, device=key.device)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(key.device).cuda_stream
    with torch.cuda.device(key.device):
        code = lib.mmg_threefry2x32(key.data_ptr(), int(base), int(n), out.data_ptr(), stream)
    check(lib, code, "threefry2x32")
    count_launch("threefry2x32")
    return out


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` -> [n, 2] on the key's device."""
    if key.is_cuda:
        return launch_threefry2x32(key, 0, n)
    return prng.split(key, n)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` -> [2] on the key's device."""
    if key.is_cuda:
        return launch_threefry2x32(key, int(data) & prng.MASK32, 1)[0]
    return prng.fold_in(key, data)


def plain_dropout(x: torch.Tensor, key: torch.Tensor, fold: int, keep: float):
    """flax's ``nn.Dropout`` in train mode under the key ``fold_in(key,
    fold)`` -> (output, bool mask)."""
    mask = prng.bernoulli(prng.fold_in(key, fold), keep, x.shape)
    keep_t = torch.tensor(keep, dtype=torch.float32, device=x.device)
    kept = (x.float() / keep_t).to(x.dtype)
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype, device=x.device)), mask


def launch_dropout(x: torch.Tensor, key: torch.Tensor, fold: int, keep: float):
    """Launch ``mmg_dropout`` (CUDA tensors only; raises on any failure) ->
    (output, uint8 mask)."""
    if not (x.is_cuda and key.is_cuda):
        raise ValueError("launch_dropout needs CUDA tensors")
    _check_key(key)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout takes float32 or bfloat16, got {x.dtype}")
    if key.device != x.device:
        raise ValueError(f"key is on {key.device}, x on {x.device}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    x, key = x.contiguous(), key.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out, mask
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_dropout(_DTYPES[x.dtype], x.data_ptr(), key.data_ptr(), int(fold) & prng.MASK32,
                               float(keep), x.numel(), out.data_ptr(), mask.data_ptr(), stream)
    check(lib, code, "dropout")
    count_launch("dropout")
    return out, mask


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, fold, keep):
        if x.is_cuda:
            out, mask = launch_dropout(x, key, fold, keep)
        else:
            out, mask = plain_dropout(x, key, fold, keep)
        ctx.keep = keep
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, grad, _grad_mask):
        (mask,) = ctx.saved_tensors
        # a fill, not a host copy: the backward may be under CUDA graph capture
        keep_t = torch.full((), ctx.keep, dtype=torch.float32, device=grad.device)
        scaled = (grad.float() / keep_t).to(grad.dtype)
        return (torch.where(mask.bool(), scaled, torch.zeros((), dtype=grad.dtype, device=grad.device)),
                None, None, None)


def dropout(x: torch.Tensor, key: torch.Tensor, fold: int, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in train mode at the scope whose fold
    constant is ``fold`` (``prng.make_rng_constant``), under the head's
    dropout key.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``plain_dropout``."""
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    out, _mask = _Dropout.apply(x, key, int(fold), keep)
    return out
