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

``fused_convnext_block_int8`` is the same block with int8 pointwise
products (the JAX ``fused_convnext_block_int8``), launching the int8 route
of the same source; see ``plain_convnext_block_int8`` for its partition of
activation scales.

The gradient goes through the plain math (``ops.run_kernel``), like the JAX
``custom_vjp``; serving never takes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import count_launch, run_kernel
from ._build import check, load_typed
from .quant import EPS as QUANT_EPS
from .quant import int8_matmul, int8_quantize

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


_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "mmg_fused_block": [_I] + [_P] * 11 + [_I, _I, _I, _I, _F, _I, _P],
    "mmg_fused_block_int8": [_I] + [_P] * 13 + [_I, _I, _I, _I, _F, _I, _P],
}


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
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_fused_block(
            _DTYPES[x.dtype], *[t.data_ptr() for t in args],
            out.data_ptr(), n, h, w, c, EPS, int(bool(gelu_tanh)), stream)
    check(lib, code, "fused_convnext_block")
    count_launch("fused_convnext_block")
    return out


def fused_convnext_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """One ConvNeXt block.  x: [n, H, W, C] NHWC, any H, W >= 1.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``plain_convnext_block``.  ``ns``/``nb`` (the LN affine) stay fp32; every
    other parameter is in x's dtype.  The gradient differentiates the plain
    math, like the JAX ``custom_vjp``; serving never takes it."""
    args = (x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)
    if x.is_cuda:
        return run_kernel(launch_fused_block, plain_convnext_block, *args,
                          gelu_tanh=bool(gelu_tanh))
    return plain_convnext_block(*args, gelu_tanh=gelu_tanh)


# ---------------------------------------------------------------------------
# The int8 block (counterpart of the JAX ``fused_convnext_block_int8``).

INV_127 = 1.0 / 127.0


def quantize_rows(v: torch.Tensor):
    """One int8 scale per row (the last axis), the JAX kernel's formula
    ``max(amax, 1e-8) * float32(1/127)``: -> (q int8, scale [..., 1] fp32)."""
    scale = torch.clamp(v.abs().amax(dim=-1, keepdim=True), min=QUANT_EPS) * INV_127
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8), scale


def quantize_weights(w1, w2):
    """Per-output-channel int8 weights, as the JAX kernel's wrapper makes
    them: -> (w1q [C, 4C], ws1 [4C], w2q [4C, C], ws2 [C])."""
    w1q, ws1 = int8_quantize(w1, axis=0)
    w2q, ws2 = int8_quantize(w2, axis=0)
    return w1q, ws1.reshape(-1), w2q, ws2.reshape(-1)


def plain_convnext_block_int8(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, eps=EPS,
                              gelu_tanh=False):
    """Plain PyTorch version of the int8 kernel, same partition of scales:
    one per pixel for pw1's input (over C) and for pw2's input (over 4C).

    The depthwise conv, LN, GELU and dequantised sums stay fp32 (the JAX int8
    kernel rounds nothing to the tower dtype inside the block); products of
    int8 values accumulate exactly in int32 (``ops.quant.int8_matmul``)."""
    c = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), dwk.float().permute(3, 2, 0, 1), padding=3,
                 groups=c).permute(0, 2, 3, 1) + dwb.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps) * ns.float() + nb.float()
    w1q, ws1, w2q, ws2 = quantize_weights(w1, w2)
    q1, s1 = quantize_rows(y)
    h = int8_matmul(q1, w1q).float() * (s1 * ws1) + b1.float()
    h = F.gelu(h, approximate="tanh" if gelu_tanh else "none")
    q2, s2 = quantize_rows(h)
    out = (int8_matmul(q2, w2q).float() * (s2 * ws2) + b2.float()) * g.float()
    return (x.float() + out).to(x.dtype)


def launch_fused_block_int8(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """Launch the int8 CUDA kernel (CUDA tensors only; raises on any failure).

    w1 / w2 arrive in x's dtype and are quantised here, per output channel,
    and packed four input rows to an int32 word for ``__dp4a``."""
    if not x.is_cuda:
        raise ValueError("launch_fused_block_int8 needs CUDA tensors")
    _check_args(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)
    n, h, w, c = x.shape
    w1q, ws1, w2q, ws2 = quantize_weights(w1, w2)

    def pack(q):  # [k, m] int8 -> [k/4, m] int32, word (i, j) = rows 4i..4i+3 of column j
        k, m = q.shape
        return q.reshape(k // 4, 4, m).permute(0, 2, 1).contiguous().view(torch.int32)[..., 0]

    args = [t.contiguous() for t in (x, dwk, dwb, ns, nb)]
    weights = [pack(w1q), ws1.contiguous(), b1.contiguous(), pack(w2q), ws2.contiguous(),
               b2.contiguous(), g.contiguous()]
    out = torch.empty_like(args[0])
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_fused_block_int8(
            _DTYPES[x.dtype], *[t.data_ptr() for t in args + weights],
            out.data_ptr(), n, h, w, c, EPS, int(bool(gelu_tanh)), stream)
    check(lib, code, "fused_convnext_block_int8")
    count_launch("fused_convnext_block_int8")
    return out


def fused_convnext_block_int8(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """One ConvNeXt block with int8 pointwise products (the arguments of
    ``fused_convnext_block``).  CUDA tensors launch the int8 kernel (or
    raise); CPU tensors run ``plain_convnext_block_int8``."""
    args = (x, dwk, dwb, ns, nb, w1, b1, w2, b2, g)
    if x.is_cuda:
        return run_kernel(launch_fused_block_int8, plain_convnext_block_int8, *args,
                          gelu_tanh=bool(gelu_tanh))
    return plain_convnext_block_int8(*args, gelu_tanh=gelu_tanh)
