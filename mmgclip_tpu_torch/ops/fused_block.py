"""The whole ConvNeXt block as one CUDA kernel, and its plain PyTorch version.

    y = x + gamma * pw2(GELU(pw1(LN(dwconv7x7(x) + dw_bias))))

Counterpart of mmgclip_tpu/ops/fused_block.py.  On a CUDA tensor
``fused_convnext_block`` launches ``csrc/fused_block.cu`` (one grid for every
image size: the TPU's whole-image, row-banded and pad-to-band routes are not
needed, see the source's header); on a CPU tensor it runs
``plain_convnext_block``, the plain version of the JAX ``_lax_block``.  The
kernel mirrors the JAX kernel's rounding points: fp32 taps and LayerNorm, the
LN output rounded to the weight dtype before pw1, the GELU output rounded
before pw2, fp32 accumulation.

The gradient goes through the plain math (``torch.autograd.Function``), like
the JAX ``custom_vjp``; serving never takes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import count_launch
from ._build import check, load

EPS = 1e-6
_SOURCE = "fused_block.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain_convnext_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, eps=EPS,
                         gelu_tanh=False):
    """Plain PyTorch ConvNeXt block in x's dtype (the JAX ``_lax_block``).

    x: [n, H, W, C]; dwk: [7, 7, 1, C]; w1: [C, 4C]; w2: [4C, C]; the
    LayerNorm statistics and affine run in fp32 and the result is cast back
    to x's dtype before pw1, as in the JAX tower."""
    c = x.shape[-1]
    dt = x.dtype
    kernel = dwk.to(dt).permute(3, 2, 0, 1)  # HWIO [7,7,1,C] -> OIHW [C,1,7,7]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=3, groups=c)
    y = y.permute(0, 2, 3, 1) + dwb.to(dt)
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf - mean).square().mean(dim=-1, keepdim=True)
    y = ((yf - mean) * torch.rsqrt(var + eps) * ns + nb).to(dt)
    y = y @ w1.to(dt) + b1.to(dt)
    y = F.gelu(y, approximate="tanh" if gelu_tanh else "none")
    y = y @ w2.to(dt) + b2.to(dt)
    return x + g.to(dt) * y


def _library():
    lib = load(_SOURCE)
    if not getattr(lib, "_mmg_typed", False):
        ptr = ctypes.c_void_p
        lib.mmg_fused_block.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ptr,
        ]
        lib.mmg_fused_block.restype = ctypes.c_int
        lib.mmg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mmg_cuda_error_string.restype = ctypes.c_char_p
        lib._mmg_typed = True
    return lib


def _check_args(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g):
    if x.dim() != 4:
        raise ValueError(f"x must be [n, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_convnext_block takes float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"fused_convnext_block needs C % 4 == 0, got C={c}")
    expected = {
        "dwk": (dwk, (7, 7, 1, c), x.dtype), "dwb": (dwb, (c,), x.dtype),
        "ns": (ns, (c,), torch.float32), "nb": (nb, (c,), torch.float32),
        "w1": (w1, (c, 4 * c), x.dtype), "b1": (b1, (4 * c,), x.dtype),
        "w2": (w2, (4 * c, c), x.dtype), "b2": (b2, (c,), x.dtype),
        "g": (g, (c,), x.dtype),
    }
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def launch_fused_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """Launch the CUDA kernel (CUDA tensors only; raises on any failure)."""
    if not x.is_cuda:
        raise ValueError("launch_fused_block needs CUDA tensors")
    _check_args(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)
    args = [t.contiguous() for t in (x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)]
    out = torch.empty_like(args[0])
    n, h, w, c = x.shape
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_fused_block(
            _DTYPES[x.dtype], *[t.data_ptr() for t in args],
            out.data_ptr(), n, h, w, c, EPS, int(bool(gelu_tanh)), stream)
    check(lib, code, "fused_convnext_block")
    count_launch("fused_convnext_block")
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh):
        ctx.gelu_tanh = gelu_tanh
        ctx.save_for_backward(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)
        return launch_fused_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = plain_convnext_block(*inputs, gelu_tanh=ctx.gelu_tanh)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def fused_convnext_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """One ConvNeXt block.  x: [n, H, W, C] NHWC, any H, W >= 1.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``plain_convnext_block``.  ``ns``/``nb`` (the LN affine) stay fp32; every
    other parameter is in x's dtype."""
    if x.is_cuda:
        return _FusedBlock.apply(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, bool(gelu_tanh))
    return plain_convnext_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g,
                                gelu_tanh=gelu_tanh)
