"""Depthwise 7x7 convolution (stride 1, SAME, plus bias) as one CUDA kernel,
and its plain PyTorch version.

Counterpart of mmgclip_tpu/ops/depthwise_conv.py (the kernel behind
``ConvNeXtConfig.use_pallas_dwconv``).  On a CUDA tensor
``depthwise_conv7x7`` launches ``csrc/depthwise_conv.cu`` for any C and any
H, W >= 1 (the TPU's ``C % 128`` and VMEM gates do not carry over); on a CPU
tensor it runs ``plain_depthwise_conv7x7``.  Both accumulate the 49 taps in
fp32 and round once to x's dtype, as the JAX kernel does.
The gradient differentiates the plain version (``ops.run_kernel``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import count_launch, run_kernel
from ._build import check, load_typed

_SOURCE = "depthwise_conv.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain_depthwise_conv7x7(x, w, b):
    """x [n, H, W, C]; w [7, 7, 1, C] (HWIO); b [C] -> [n, H, W, C] in x's
    dtype, fp32 accumulation."""
    c = x.shape[-1]
    kernel = w.float().permute(3, 2, 0, 1)  # [C, 1, 7, 7]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel, padding=3, groups=c)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)


_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {"mmg_depthwise_conv7x7": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def _check_args(x, w, b):
    if x.dim() != 4:
        raise ValueError(f"x must be [n, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise_conv7x7 takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    for name, t, shape in (("w", w, (7, 7, 1, c)), ("b", b, (c,))):
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def launch_depthwise_conv7x7(x, w, b):
    """Launch the CUDA kernel (CUDA tensors only; raises on any failure)."""
    if not x.is_cuda:
        raise ValueError("launch_depthwise_conv7x7 needs CUDA tensors")
    _check_args(x, w, b)
    x, w, b = (t.contiguous() for t in (x, w, b))
    out = torch.empty_like(x)
    n, h, wd, c = x.shape
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_depthwise_conv7x7(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                                         b.data_ptr(), out.data_ptr(), n, h, wd, c, stream)
    check(lib, code, "depthwise_conv7x7")
    count_launch("depthwise_conv7x7")
    return out


def depthwise_conv7x7(x, w, b):
    """Depthwise 7x7, stride 1, SAME, plus bias; w and b in x's dtype.  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain version."""
    if x.is_cuda:
        return run_kernel(launch_depthwise_conv7x7, plain_depthwise_conv7x7, x, w, b)
    return plain_depthwise_conv7x7(x, w, b)
