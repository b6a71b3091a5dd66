"""The ConvNeXt downsample (LayerNorm + 2x2/2 conv + bias) as one CUDA
kernel, and its plain PyTorch version.

Counterpart of mmgclip_tpu/ops/fused_downsample.py.  On a CUDA tensor
``fused_ln_downsample`` launches ``csrc/fused_downsample.cu`` (an LN-prologue
GEMM on the tensor cores: the 2x2 patches as rows of A [M, 4 Cin], the
kernel as W [4 Cin, Cout]) for any H, W >= 1 and Cin, Cout multiples of 4;
on a CPU tensor it runs ``plain_ln_downsample``, the counterpart of
the JAX ``_lax_ln_downsample``: LayerNorm in fp32 (two-pass variance, eps
1e-6), the result rounded to x's dtype, zero padding bottom/right to even
H, W after the norm (so odd sizes come out as the JAX tower's LN-then-pad
order gives them), then the conv with fp32 accumulation plus the bias.
The gradient differentiates the plain version (``ops.run_kernel``).
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch, run_kernel
from ._build import check, load_typed
from .fused_stem import patchify

EPS = 1e-6
_SOURCE = "fused_downsample.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain_ln_downsample(x, ns, nb, kernel, bias, eps=EPS):
    """x [n, H, W, Cin]; ns, nb [Cin] fp32; kernel [2, 2, Cin, Cout] and bias
    [Cout] in x's dtype -> [n, ceil(H/2), ceil(W/2), Cout] in x's dtype."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ns.float() + nb.float()).to(x.dtype)
    out = patchify(y.float(), 2) @ kernel.float().reshape(4 * cin, cout) + bias.float()
    return out.to(x.dtype)


_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {"mmg_fused_downsample": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        ctypes.c_float, _P]}
MAX_CHANNELS = 1536  # 96 output columns a warp, at most 16 warps across


def _check_args(x, ns, nb, kernel, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be [n, H, W, Cin], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_ln_downsample takes float32 or bfloat16, got {x.dtype}")
    cin = x.shape[-1]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (2, 2, cin) or kernel.dtype != x.dtype:
        raise ValueError(f"kernel must be {x.dtype} [2, 2, {cin}, Cout], "
                         f"got {kernel.dtype} {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if cin % 4 or cout % 4 or max(cin, cout) > MAX_CHANNELS:
        raise ValueError(f"the downsample kernel takes Cin and Cout multiples of 4 and <= "
                         f"{MAX_CHANNELS}, got Cin={cin}, Cout={cout}")
    for name, t, shape, dtype in (("ns", ns, (cin,), torch.float32),
                                  ("nb", nb, (cin,), torch.float32),
                                  ("bias", bias, (cout,), x.dtype)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("ns", ns), ("nb", nb), ("kernel", kernel), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def launch_fused_ln_downsample(x, ns, nb, kernel, bias):
    """Launch the CUDA kernel (CUDA tensors only; raises on any failure)."""
    if not x.is_cuda:
        raise ValueError("launch_fused_ln_downsample needs CUDA tensors")
    _check_args(x, ns, nb, kernel, bias)
    # 8- and 16-byte vectors: a view off a 16-byte boundary is copied
    x, ns, nb, kernel, bias = (t if t.data_ptr() % 16 == 0 else t.clone()
                               for t in (t.contiguous() for t in (x, ns, nb, kernel, bias)))
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    out = torch.empty(n, -(-h // 2), -(-w // 2), cout, dtype=x.dtype, device=x.device)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_fused_downsample(_DTYPES[x.dtype], x.data_ptr(), ns.data_ptr(),
                                        nb.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), n, h, w, cin, cout, EPS, stream)
    check(lib, code, "fused_ln_downsample")
    count_launch("fused_ln_downsample")
    return out


def fused_ln_downsample(x, ns, nb, kernel, bias):
    """LayerNorm + 2x2/2 conv.  CUDA tensors launch the kernel (or raise);
    CPU tensors run ``plain_ln_downsample``."""
    if x.is_cuda:
        return run_kernel(launch_fused_ln_downsample, plain_ln_downsample, x, ns, nb, kernel, bias)
    return plain_ln_downsample(x, ns, nb, kernel, bias)
