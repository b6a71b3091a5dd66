"""Causal latent attention of the DeepSeek-V3 text tower (MLA without query
compression) over a padded chunk: the CUDA kernel ``csrc/mla_attention.cu``
and its plain version.

The inputs are the layer's projections as ``F.linear`` returns them, read in
place: ``q`` ``[b, s, H (nope + rope)]`` (per head ``q_nope``, then ``q_pe``
not yet rotated), ``k_pe`` ``[b, s, rope]`` (the rope key every head shares:
the last columns of the ``kv_a_proj_with_mqa`` output, a view at its row
stride), ``kv`` ``[b, s, H (nope + v)]`` (per head ``k_nope``, then ``v``),
the float32 RoPE tables ``cos``, ``sin`` ``[s, rope / 2]``
(``models/deepseek_v3.py::rope_tables``) and the key mask ``keys`` ``[b, s]``
(nonzero where a key is valid).  The attention is causal: query i attends key
j iff j <= i and ``keys[j]`` is set; no other mask is taken.  The output is
the context ``[b, s, H v]`` in the inputs' dtype, laid out as ``o_proj``
reads it.

With ``cos`` and ``sin`` None the attention has no positions (NoPE, as
Kimi-Linear's latent attention): ``q_pe`` and ``k_pe`` stay as projected and
still take part in the scores, whose scale stays 1 / sqrt(nope + rope).

``plain_mla_attention`` is the arithmetic the tower ran in plain PyTorch:
RoPE on adjacent pairs in float32 (``rope_pairs``), q and k widened to
float32, scores q.k / sqrt(nope + rope) under the tower's ``[b, 1, s, s]``
mask (``models/deepseek_v3.py::attention_masks`` of ``keys``; ``NEG_INF``
where it is False), softmax, probabilities rounded to v's dtype, P v.
``launch_mla_attention`` applies the same causal rule on the card; its masked
keys, its pad queries (they attend to the row's valid keys) and its queries
with no allowed key (the plain path's uniform softmax over all s keys) give
what the plain path gives, within the order of float32 sums and the rounding
of P to bf16 (source header).  ``mla_attention``: a CUDA tensor launches the
kernel (launch count ``mla_attention``: one a call) or raises; a CPU tensor
runs the plain version.  No gradient: the tower is frozen.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import count_launch
from ._build import check, load_typed
from .flash_attention import NEG_INF

_SOURCE = "mla_attention.cu"
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {"mmg_mla_attention": [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _L, _P, _P,
                                     _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]}
KERNEL_DIMS = ((128, 64, 128), (16, 8, 16))  # (nope, rope, v) the kernel is built for


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (2i, 2i + 1) of ``x`` ``[b, s, heads, dim]`` by
    the tables of ``rope_tables`` (``[s, dim // 2]``), in float32."""
    xf = x.float().unflatten(-1, (-1, 2))
    c, s = cos[None, :, None], sin[None, :, None]
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack((a * c - b * s, a * s + b * c), dim=-1).flatten(-2).to(x.dtype)


def _dims(q: torch.Tensor, k_pe: torch.Tensor, kv: torch.Tensor, heads: int) -> tuple:
    """-> (nope, rope, v) from the widths, or raise."""
    rope = k_pe.shape[-1]
    if (q.dim() != 3 or k_pe.dim() != 3 or kv.dim() != 3 or q.shape[-1] % heads
            or kv.shape[-1] % heads):
        raise ValueError(f"mla_attention takes q [b, s, H qk], k_pe [b, s, rope], kv [b, s, "
                         f"H (nope + v)] with H = {heads}; got {tuple(q.shape)}, "
                         f"{tuple(k_pe.shape)}, {tuple(kv.shape)}")
    nope = q.shape[-1] // heads - rope
    v = kv.shape[-1] // heads - nope
    if nope <= 0 or v <= 0 or q.shape[:2] != k_pe.shape[:2] or q.shape[:2] != kv.shape[:2]:
        raise ValueError(f"mla_attention: q {tuple(q.shape)}, k_pe {tuple(k_pe.shape)}, "
                         f"kv {tuple(kv.shape)} do not fit {heads} heads")
    return nope, rope, v


def plain_mla_attention(q: torch.Tensor, k_pe: torch.Tensor, kv: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, keys: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention in plain PyTorch (module docstring)."""
    from ..models.deepseek_v3 import attention_masks  # the tower imports this module

    nope, rope, vd = _dims(q, k_pe, kv, heads)
    mask = attention_masks(keys)
    b, s, _ = q.shape
    H = heads
    q = q.view(b, s, H, nope + rope)
    kv = kv.view(b, s, H, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe, k_pe = q[..., nope:], k_pe[:, :, None]
    if cos is not None:
        q_pe, k_pe = rope_pairs(q_pe, cos, sin), rope_pairs(k_pe, cos, sin)
    k_pe = k_pe.expand(b, s, H, rope)
    query = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(1, 2).float()
    key = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2).float()
    scores = torch.matmul(query, key.transpose(-1, -2)) * (1.0 / math.sqrt(nope + rope))
    del query, key
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, H * vd)


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"launch_mla_attention: {name} must be bf16 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if t.stride(-1) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"launch_mla_attention: {name} needs a contiguous last dimension, batch "
                         f"and position strides that are multiples of 8 and a 16-byte aligned "
                         f"start; got strides {t.stride()}")


def launch_mla_attention(q: torch.Tensor, k_pe: torch.Tensor, kv: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, keys: torch.Tensor, heads: int, rotated: bool = False):
    """Launch the kernel (CUDA tensors only; raises on any failure; ``cos``
    and ``sin`` None: no rotation, the kernel's NoPE path).  ``keys``
    ``[b, s]``: bool or uint8 are read in place, other dtypes compared with 0
    first.  -> the context, or with ``rotated`` (context, rotated q_pe ``[b,
    s, H, rope]``, rotated k_pe ``[b, s, rope]`` of the keys the kernel
    loaded)."""
    if (cos is None) != (sin is None):
        raise ValueError("launch_mla_attention takes both rope tables or neither")
    if not all(t.is_cuda for t in (q, k_pe, kv, keys) + ((cos, sin) if cos is not None else ())):
        raise ValueError("launch_mla_attention needs CUDA tensors")
    nope, rope, vd = _dims(q, k_pe, kv, heads)
    if (nope, rope, vd) not in KERNEL_DIMS:
        raise ValueError(f"launch_mla_attention is built for (nope, rope, v) in {KERNEL_DIMS}, "
                         f"got {(nope, rope, vd)}")
    device = q.device
    for name, t in (("q", q), ("k_pe", k_pe), ("kv", kv)):
        _check_operand(name, t, device)
    b, s, _ = q.shape
    if b > 65535 or heads > 65535:
        raise ValueError(f"launch_mla_attention: at most 65,535 rows and heads, got {b}, {heads}")
    for name, t in (("cos", cos), ("sin", sin)) if cos is not None else ():
        if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (s, rope // 2) or t.data_ptr() % 16):
            raise ValueError(f"launch_mla_attention: {name} must be contiguous, 16-byte aligned "
                             f"float32 [{s}, {rope // 2}] on {device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tuple(keys.shape) != (b, s) or keys.device != device:
        raise ValueError(f"launch_mla_attention: keys must be [{b}, {s}] on {device}")
    if keys.dtype not in (torch.bool, torch.uint8) or keys.stride(1) != 1:
        keys = keys != 0
    out = torch.empty(b, s, heads * vd, dtype=q.dtype, device=device)
    q_rot = k_rot = None
    if rotated:
        q_rot = torch.zeros(b, s, heads, rope, dtype=q.dtype, device=device)
        k_rot = torch.zeros(b, s, rope, dtype=q.dtype, device=device)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = lib.mmg_mla_attention(
            q.data_ptr(), q.stride(0), q.stride(1), k_pe.data_ptr(), k_pe.stride(0), k_pe.stride(1),
            kv.data_ptr(), kv.stride(0), kv.stride(1), 0 if cos is None else cos.data_ptr(),
            0 if sin is None else sin.data_ptr(),
            keys.data_ptr(), keys.stride(0), out.data_ptr(),
            0 if q_rot is None else q_rot.data_ptr(), 0 if k_rot is None else k_rot.data_ptr(),
            b, heads, s, nope, rope, vd, 1.0 / math.sqrt(nope + rope), stream)
    check(lib, code, "mla_attention")
    count_launch("mla_attention")
    return (out, q_rot, k_rot) if rotated else out


def mla_attention(q: torch.Tensor, k_pe: torch.Tensor, kv: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, keys: torch.Tensor, heads: int) -> torch.Tensor:
    """The context of one causal attention layer over the ``[b, s]`` key
    mask ``keys`` (module docstring).  CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if q.is_cuda:
        return launch_mla_attention(q, k_pe, kv, cos, sin, keys, heads)
    return plain_mla_attention(q, k_pe, kv, cos, sin, keys, heads)
