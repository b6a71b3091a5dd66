"""The ConvNeXt stem (4x4/4 conv + bias + LayerNorm) as one CUDA kernel, and
its plain PyTorch version.

Counterpart of mmgclip_tpu/ops/fused_stem.py.  On a CUDA tensor
``fused_stem`` launches ``csrc/fused_stem.cu`` for any H, W >= 1, Cin <= 4
and Cout <= 256 (persistent CTAs stage the four input rows of a 64-pixel
output row segment by ``cp.async`` and run the patch products on the tensor
cores; the TPU's patch gather outside the kernel and its VMEM bands do not
carry over); on a CPU tensor it runs ``plain_stem``.  Both round the patches to the kernel's dtype,
accumulate in fp32, add the bias, run the LayerNorm in fp32 over the output
channels and return x's dtype, as the JAX kernel does.  Bottom/right zero
padding to a multiple of 4 is the JAX tower's ``br_pad``.
The gradient differentiates the plain version (``ops.run_kernel``).
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch, run_kernel
from ._build import check, load_typed

EPS = 1e-6
MAX_CIN, MAX_COUT = 4, 256  # the kernel's limits (K = 16 Cin <= 64, N <= 256)
_SOURCE = "fused_stem.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def patchify(x: torch.Tensor, s: int) -> torch.Tensor:
    """[n, H, W, C] -> [n, ceil(H/s), ceil(W/s), s*s*C] non-overlapping s x s
    patches, (dy, dx, ci)-minor (the row order of an HWIO kernel reshaped to
    [s*s*C, Cout]), zeros past the bottom/right edge (the JAX tower's
    ``br_pad``)."""
    n, h, w, c = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, (-w) % s, 0, (-h) % s))
    ho, wo = x.shape[1] // s, x.shape[2] // s
    return x.reshape(n, ho, s, wo, s, c).permute(0, 1, 3, 2, 4, 5).reshape(n, ho, wo, s * s * c)


def plain_stem(x, kernel, bias, ns, nb, eps=EPS):
    """x [n, H, W, Cin]; kernel [4, 4, Cin, Cout] and bias [Cout] in one
    dtype; ns, nb [Cout] fp32 -> [n, ceil(H/4), ceil(W/4), Cout] in x's dtype."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    patches = patchify(x, 4).to(kernel.dtype).float()
    y = patches @ kernel.float().reshape(16 * cin, cout) + bias.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    return ((y - mean) * torch.rsqrt(var + eps) * ns.float() + nb.float()).to(x.dtype)


_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {"mmg_fused_stem": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _P]}


def _check_args(x, kernel, bias, ns, nb):
    if x.dim() != 4:
        raise ValueError(f"x must be [n, H, W, Cin], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES or kernel.dtype not in _DTYPES:
        raise TypeError(f"fused_stem takes float32 or bfloat16, got x {x.dtype}, "
                        f"kernel {kernel.dtype}")
    cin = x.shape[-1]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (4, 4, cin):
        raise ValueError(f"kernel must be [4, 4, {cin}, Cout], got {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    for name, t, dtype in (("bias", bias, kernel.dtype), ("ns", ns, torch.float32),
                           ("nb", nb, torch.float32)):
        if tuple(t.shape) != (cout,) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape ({cout},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("kernel", kernel), ("bias", bias), ("ns", ns), ("nb", nb)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def launch_fused_stem(x, kernel, bias, ns, nb):
    """Launch the CUDA kernel (CUDA tensors only; raises on any failure)."""
    if not x.is_cuda:
        raise ValueError("launch_fused_stem needs CUDA tensors")
    _check_args(x, kernel, bias, ns, nb)
    if x.shape[-1] > MAX_CIN or kernel.shape[3] > MAX_COUT:
        raise ValueError(f"the stem kernel takes Cin <= {MAX_CIN} and Cout <= {MAX_COUT}, "
                         f"got Cin {x.shape[-1]}, Cout {kernel.shape[3]}")
    x, kernel, bias, ns, nb = (t.contiguous() for t in (x, kernel, bias, ns, nb))
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    out = torch.empty(n, -(-h // 4), -(-w // 4), cout, dtype=x.dtype, device=x.device)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mmg_fused_stem(_DTYPES[x.dtype], _DTYPES[kernel.dtype], x.data_ptr(),
                                  kernel.data_ptr(), bias.data_ptr(), ns.data_ptr(),
                                  nb.data_ptr(), out.data_ptr(), n, h, w, cin, cout, EPS, stream)
    check(lib, code, "fused_stem")
    count_launch("fused_stem")
    return out


def fused_stem(x, kernel, bias, ns, nb):
    """ConvNeXt stem.  CUDA tensors launch the kernel (or raise); CPU tensors
    run ``plain_stem``."""
    if x.is_cuda:
        return run_kernel(launch_fused_stem, plain_stem, x, kernel, bias, ns, nb)
    return plain_stem(x, kernel, bias, ns, nb)
