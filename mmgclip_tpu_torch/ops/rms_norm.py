"""RMSNorm over the last dimension, optionally gated: the CUDA kernel
``csrc/rms_norm.cu`` and its plain version.

``x`` ``[..., W]`` and ``weight`` ``[W]``; the arithmetic, with float32
statistics and one rounding to ``dtype`` (``x``'s by default):

* y = float(x) * rsqrt(mean(float(x)^2) + eps) * float(weight);
* with ``gate`` (``x``'s shape): y = y * sigmoid(float(gate)), the Kimi-Linear
  KDA layer's output gate over its per-head rows.

The DeepSeek-V3 family's towers run every norm through ``rms_norm``: the
input and post-attention norms, the latent attention's ``kv_a_layernorm``
(its input the split view of the ``kv_a`` projection, read in place at its
row stride), the final norm into float32, and Kimi's gated ``o_norm``.

``rms_norm``: CUDA tensors launch the kernel (launch count ``rms_norm``: one
a call) or raise; CPU tensors run ``plain_rms_norm``.  The kernel reads bf16
rows (W a multiple of 8, at most 2,304; a row stride that is a multiple of 8;
16-byte aligned starts) and writes bf16 or float32.  No gradient: the towers
are frozen.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import count_launch
from ._build import check, load_typed

_SOURCE = "rms_norm.cu"
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {"mmg_rms_norm": [_P, _L, _P, _P, _L, _P, _I, _L, _I, ctypes.c_float, _P]}
MAX_WIDTH = 2304  # the kernel's widest class: Kimi-Linear's hidden rows
OUT_DTYPES = (torch.bfloat16, torch.float32)


def plain_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype=None,
                   gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The norm in plain PyTorch (module docstring)."""
    dtype = x.dtype if dtype is None else dtype
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float()
    if gate is not None:
        out = out * torch.sigmoid(gate.float())
    return out.to(dtype)


def _rows(name: str, t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as ``[rows, width]`` rows at one stride, without a copy, or raise."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"launch_rms_norm: {name} must be bf16, got {t.dtype}")
    try:
        rows = t.view(-1, width)
    except RuntimeError as exc:
        raise ValueError(f"launch_rms_norm: {name} {tuple(t.shape)} at strides {t.stride()} is "
                         f"not rows of one stride") from exc
    if rows.stride(1) != 1 or rows.stride(0) % 8 or rows.data_ptr() % 16:
        raise ValueError(f"launch_rms_norm: {name} needs a contiguous last dimension, a row "
                         f"stride that is a multiple of 8 and a 16-byte aligned start; got "
                         f"strides {t.stride()}")
    return rows


def launch_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype=None,
                    gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only; raises on any failure)."""
    tensors = (x, weight) if gate is None else (x, weight, gate)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("launch_rms_norm needs CUDA tensors")
    dtype = x.dtype if dtype is None else dtype
    if dtype not in OUT_DTYPES:
        raise ValueError(f"launch_rms_norm writes bf16 or float32, not {dtype}")
    width = x.shape[-1]
    if width % 8 or not 8 <= width <= MAX_WIDTH:
        raise ValueError(f"launch_rms_norm takes rows of a multiple of 8 up to {MAX_WIDTH}, "
                         f"got {width}")
    device = x.device
    if any(t.device != device for t in tensors):
        raise ValueError("launch_rms_norm: x, weight and gate must be on one device")
    if (tuple(weight.shape) != (width,) or weight.dtype != torch.bfloat16
            or not weight.is_contiguous() or weight.data_ptr() % 16):
        raise ValueError(f"launch_rms_norm: weight must be [{width}] bf16, contiguous and 16-byte "
                         f"aligned, got {tuple(weight.shape)} {weight.dtype}")
    if gate is not None and gate.shape != x.shape:
        raise ValueError(f"launch_rms_norm: gate {tuple(gate.shape)}, x {tuple(x.shape)}")
    rows = _rows("x", x, width)
    gate_rows = None if gate is None else _rows("gate", gate, width)
    out = torch.empty(x.shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = lib.mmg_rms_norm(
            rows.data_ptr(), rows.stride(0), weight.data_ptr(),
            None if gate_rows is None else gate_rows.data_ptr(),
            0 if gate_rows is None else gate_rows.stride(0), out.data_ptr(),
            int(dtype == torch.float32), rows.shape[0], width, float(eps), stream)
    check(lib, code, "rms_norm")
    count_launch("rms_norm")
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype=None,
             gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The norm (module docstring).  CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if x.is_cuda:
        return launch_rms_norm(x, weight, eps, dtype, gate)
    return plain_rms_norm(x, weight, eps, dtype, gate)
