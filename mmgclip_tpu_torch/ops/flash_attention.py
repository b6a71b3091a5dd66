"""Flash attention with per-row valid key lengths, and its plain version.

Counterpart of mmgclip_tpu/ops/flash_attention.py (``_flash_call`` /
``_flash_kernel``).  On CUDA tensors ``flash_attention`` launches
``csrc/flash_attention.cu`` for any s and any d <= 128 (the TPU's s >= 128
tiling floor does not carry over, so the pad-trimmed s = 32 prompt banks run
the kernel); on CPU tensors it runs ``attention_reference``.  The kernel
reduces the mask to per-row lengths, so a mask that is not a contiguous
valid prefix goes to ``attention_reference`` on either device — the same
routing as the JAX wrapper.

On an H100 the kernel is bound by operations (4 * s * keys * d per head) at
BERT sizes, so its products run on the tensor cores: a warp owns 16 query
rows, K and V tiles of 32 keys arrive by double-buffered ``cp.async``, and
``mma.sync`` computes S = Q K^T and P V with the online softmax on the S
fragment in registers — bf16 operands with fp32 sums in bf16, and in fp32 a
three-pass TF32 split (a_lo b_hi + a_hi b_lo + a_hi b_hi), which holds the
fp32 result within 1e-5 of ``attention_reference`` (see the source's
header and PERF.md for the measured error).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import count_launch, run_kernel
from ._build import check, load_typed

NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, mask=None):
    """Plain softmax attention.  q, k, v: [b, h, s, d]; mask: [b, s] key
    validity.  Scores in fp32; probabilities cast to v's dtype before PV."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].bool(), scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {"mmg_flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]}


def prefix_lengths(mask, s: int):
    """[b] int32 valid lengths when ``mask`` is a contiguous valid prefix per
    row (right padding), else None.  Reads the mask back to decide."""
    m = mask.to(torch.int32)
    lengths = m.sum(dim=-1, dtype=torch.int32)
    prefix = (torch.arange(s, device=m.device)[None, :] < lengths[:, None]).to(torch.int32)
    if not torch.equal(m, prefix):
        return None
    return lengths


def launch_flash_attention(q, k, v, lengths):
    """Launch the CUDA kernel.  lengths: [b] int32 valid prefix lengths."""
    if not q.is_cuda:
        raise ValueError("launch_flash_attention needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    b, h, s, d = q.shape
    if d > 128:
        raise ValueError(f"flash_attention takes head dims up to 128, got {d}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} on {t.device}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 or lengths.device != q.device:
        raise ValueError(f"lengths must be int32 [{b}] on {q.device}")
    q, k, v, lengths = (t.contiguous() for t in (q, k, v, lengths))
    out = torch.empty_like(q)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.mmg_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, h, s, d, 1.0 / math.sqrt(d), stream)
    check(lib, code, "flash_attention")
    count_launch("flash_attention")
    return out


def reference_with_lengths(q, k, v, lengths):
    """``attention_reference`` under the prefix mask of ``lengths`` [b]."""
    s = q.shape[2]
    return attention_reference(q, k, v, torch.arange(s, device=q.device)[None, :] < lengths[:, None])


def flash_attention(q, k, v, mask=None, lengths=None):
    """Fused attention.  q, k, v: [b, h, s, d]; mask: [b, s] (1 = valid key).

    CONTRACT as in the JAX package: the kernel takes the mask as per-row
    prefix lengths; a mask that is not a contiguous prefix runs
    ``attention_reference`` instead.  A caller that already holds the
    lengths of a prefix mask (``prefix_lengths``) passes ``lengths`` instead
    of ``mask`` and skips the check."""
    b, _h, s, _d = q.shape
    if lengths is not None:
        if mask is not None:
            raise ValueError("pass mask or lengths, not both")
        if not q.is_cuda:
            return reference_with_lengths(q, k, v, lengths)
        return run_kernel(launch_flash_attention, reference_with_lengths, q, k, v, lengths)
    if not q.is_cuda:
        return attention_reference(q, k, v, mask)
    if mask is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    else:
        lengths = prefix_lengths(mask, s)
        if lengths is None:
            return attention_reference(q, k, v, mask)
    return run_kernel(launch_flash_attention, reference_with_lengths, q, k, v, lengths)
