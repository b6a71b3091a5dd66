"""The scan of a Kimi Delta Attention (KDA) layer (``models/kimi_linear.py``)
over a padded chunk: the CUDA kernel ``csrc/kda.cu`` and its plain version.

Inputs, as the layer's projections give them (read in place):
``q``, ``k``, ``v`` ``[b, s, H d]`` before their short convolutions, ``f``
``[b, s, H d]`` the decay gate's pre-activation, ``beta`` ``[b, s, H]``
logits; the depthwise convolutions ``conv_q``, ``conv_k``, ``conv_v`` ``[H d,
4]`` (HF's ``[H d, 1, 4]`` with the middle dimension dropped; tap 3 multiplies
the current token); ``a_log`` ``[H]`` and ``dt_bias`` ``[H d]`` float32;
``lengths`` ``[b]`` int32, each row's valid prefix (right padding: the
recurrence is causal, so padding needs no mask).  The arithmetic, in
float32 (``d`` = 128 at the published widths):

* x = silu(causal depthwise conv_4(x)) for q, k and v, zeros before position 0;
* q and k scaled per head by rsqrt(sum of squares + 1e-6) (``L2_EPS``);
* g = -exp(a_log[head]) * softplus(f + dt_bias), alpha = exp(g); beta = sigmoid;
* per (row, head), the state S ``[d, d]`` from 0: S <- diag(alpha_t) S;
  S <- S + beta_t k_t (v_t - S^T k_t)^T; o_t = d^-1/2 S^T q_t.

The output ``o`` ``[b, s, H d]`` is in ``q``'s dtype, 0 at every position at
or past a row's length (neither path lets padding reach a valid position).

``plain_kda`` runs the scan in its chunked form, chunks of ``CHUNK`` = 64
tokens: within a chunk, G is the running sum of g from the chunk's start, and
every exponent is a difference G_t - G_s with s <= t (the chunk's start
counting as 0), never exp of a sum alone, so nothing overflows however strong
the decay (a chunk's G reaches hundreds at ``a_log`` = log 16).  With
M[t, s] = beta_s sum_i k_t,i k_s,i exp(G_t,i - G_s,i) (s < t), the chunk's
u = (I + M)^-1 (V - (exp(G) k) S_0) (a unit lower-triangular solve), its
outputs d^-1/2 ((exp(G) q) S_0 + P (beta u)) with P[t, s] = sum_i q_t,i k_s,i
exp(G_t,i - G_s,i) (s <= t), and the next state exp(G_n) S_0 + (exp(G_n - G)
k)^T (beta u).  ``recurrent_kda`` is the token-by-token recurrence (the
variant ``state_dtype=torch.bfloat16`` needs it on the CPU).

Variants, the benchmark's planted faults (the tower runs none): ``reset_every``
zeroes the state before every token at a multiple of it; ``head_decay`` gives
every channel of a head the mean of the head's g (one scalar gate a head, as
Gated DeltaNet's); ``state_dtype=torch.bfloat16`` rounds the state to bf16
after each token's update.

``kda``: a CUDA tensor launches the kernel (launch count ``kda``: one a
call) or raises; a CPU tensor runs ``plain_kda``.  No gradient: the tower is
frozen.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from . import count_launch
from ._build import check, load_typed

_SOURCE = "kda.cu"
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {"mmg_kda": [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P,
                           _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]}
KERNEL_HEAD_DIMS = (128,)  # the kernel's head size: the published one
CHUNK = 64
L2_EPS = 1e-6


def _check(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths) -> tuple:
    """-> (heads, head_dim), or raise."""
    b, s, width = q.shape
    heads = beta.shape[-1]
    if width % heads or beta.shape != (b, s, heads):
        raise ValueError(f"kda: q {tuple(q.shape)} and beta {tuple(beta.shape)} do not fit")
    for name, t in (("k", k), ("v", v), ("f", f)):
        if t.shape != q.shape:
            raise ValueError(f"kda: {name} {tuple(t.shape)}, q {tuple(q.shape)}")
    for name, t in (("conv_q", conv_q), ("conv_k", conv_k), ("conv_v", conv_v)):
        if tuple(t.shape) != (width, 4):
            raise ValueError(f"kda: {name} must be [{width}, 4], got {tuple(t.shape)}")
    if tuple(a_log.shape) != (heads,) or tuple(dt_bias.shape) != (width,):
        raise ValueError(f"kda: a_log [{heads}] and dt_bias [{width}], got "
                         f"{tuple(a_log.shape)}, {tuple(dt_bias.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"kda: lengths must be [{b}], got {tuple(lengths.shape)}")
    return heads, width // heads


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``[b, s, C]`` through the depthwise taps ``w`` ``[C, 4]``:
    sum over tau of w[:, tau] x[t - 3 + tau], zeros before position 0."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, 3, 0))
    w = w.float()
    out = w[:, 0] * xp[:, 0:s]
    for tau in range(1, 4):
        out = out + w[:, tau] * xp[:, tau:tau + s]
    return out


def prepare(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, heads: int,
            head_decay: bool = False) -> tuple:
    """The scan's float32 operands, ``[b, H, s, d]`` (``beta`` ``[b, H, s]``):
    q and k convolved, activated and normalized (q also scaled by d^-1/2), v
    convolved and activated, g the log-decay."""
    b, s, width = q.shape
    d = width // heads

    def heads_first(x):
        return x.view(b, s, heads, d).transpose(1, 2)

    qc = heads_first(F.silu(causal_conv(q.float(), conv_q)))
    kc = heads_first(F.silu(causal_conv(k.float(), conv_k)))
    vc = heads_first(F.silu(causal_conv(v.float(), conv_v)))
    qc = qc * torch.rsqrt(qc.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
    kc = kc * torch.rsqrt(kc.square().sum(-1, keepdim=True) + L2_EPS)
    g = -torch.exp(a_log.float()).view(1, heads, 1, 1) * heads_first(
        F.softplus(f.float() + dt_bias.float()))
    if head_decay:
        g = g.mean(-1, keepdim=True).expand_as(g)
    return qc, kc, vc, g, torch.sigmoid(beta.float()).transpose(1, 2)


def _chunked(q, k, v, g, beta, reset_every: int) -> torch.Tensor:
    """The chunked scan (module docstring) of ``[B, H, s, d]`` operands."""
    B, H, s, d = q.shape
    S = q.new_zeros(B, H, d, d)
    out = torch.empty_like(v)
    for c0 in range(0, s, CHUNK):
        if reset_every and c0 % reset_every == 0:
            S = torch.zeros_like(S)
        qc, kc, vc, bc = (t[:, :, c0:c0 + CHUNK] for t in (q, k, v, beta))
        G = torch.cumsum(g[:, :, c0:c0 + CHUNK], dim=2)
        n = G.shape[2]
        lower = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        # exp(G_t - G_s) for s <= t, 0 above the diagonal: every exponent <= 0
        decay = torch.exp((G[:, :, :, None] - G[:, :, None]).masked_fill(
            ~lower[None, None, :, :, None], float("-inf")))
        kk = torch.einsum("bhti,bhtsi,bhsi->bhts", kc, decay, kc)
        qk = torch.einsum("bhti,bhtsi,bhsi->bhts", qc, decay, kc)
        del decay
        M = (kk * bc[:, :, None, :]).tril(-1) + torch.eye(n, device=q.device)
        rhs = vc - (torch.exp(G) * kc) @ S
        u = torch.linalg.solve_triangular(M, rhs, upper=False, unitriangular=True)
        bu = u * bc[..., None]
        out[:, :, c0:c0 + n] = (torch.exp(G) * qc) @ S + qk @ bu
        last = G[:, :, -1:]
        S = (torch.exp(last).transpose(-1, -2) * S
             + (torch.exp(last - G) * kc).transpose(-1, -2) @ bu)
    return out


def recurrent_kda(q, k, v, g, beta, reset_every: int = 0,
                  state_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The token-by-token recurrence of ``[B, H, s, d]`` operands (from
    ``prepare``): the state rounded to ``state_dtype`` after each update."""
    B, H, s, d = q.shape
    S = q.new_zeros(B, H, d, d)
    out = torch.empty_like(v)
    for t in range(s):
        if reset_every and t % reset_every == 0:
            S = torch.zeros_like(S)
        S = torch.exp(g[:, :, t, :, None]) * S
        kt = k[:, :, t]
        u = v[:, :, t] - (S * kt[..., None]).sum(-2)
        S = S + beta[:, :, t, None, None] * kt[..., None] * u[..., None, :]
        S = S.to(state_dtype).float()
        out[:, :, t] = (S * q[:, :, t, :, None]).sum(-2)
    return out


def plain_kda(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths,
              reset_every: int = 0, head_decay: bool = False,
              state_dtype: torch.dtype = torch.float32, block_rows: Optional[int] = None):
    """The scan in plain PyTorch (module docstring), ``block_rows`` rows at a
    time (default: as many as keep the chunk's decay tensor near 1 GiB)."""
    heads, d = _check(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths)
    b, s, width = q.shape
    if block_rows is None:
        block_rows = max(1, 2 ** 28 // (heads * CHUNK * CHUNK * d))
    out = torch.empty(b, s, width, dtype=q.dtype, device=q.device)
    for r0 in range(0, b, block_rows):
        rows = slice(r0, r0 + block_rows)
        ops = prepare(q[rows], k[rows], v[rows], f[rows], beta[rows], conv_q, conv_k, conv_v,
                      a_log, dt_bias, heads, head_decay)
        if state_dtype == torch.float32:
            o = _chunked(*ops, reset_every)
        else:
            o = recurrent_kda(*ops, reset_every, state_dtype)
        n = o.shape[0]
        o = o.transpose(1, 2).reshape(n, s, width)
        valid = torch.arange(s, device=q.device)[None, :] < lengths[rows].to(q.device)[:, None]
        out[rows] = (o * valid[..., None]).to(q.dtype)
    return out


def _check_operand(name: str, t: torch.Tensor, device, copied: bool) -> None:
    if t.device != device or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
        raise ValueError(f"launch_kda: {name} must be bf16 on {device} with a contiguous last "
                         f"dimension, got {t.dtype} on {t.device}, strides {t.stride()}")
    if copied and (t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16):
        raise ValueError(f"launch_kda: {name} needs batch and position strides that are "
                         f"multiples of 8 and a 16-byte aligned start; got {t.stride()}")


def launch_kda(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths,
               reset_every: int = 0, head_decay: bool = False,
               state_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only; raises on any failure)."""
    tensors = (q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("launch_kda needs CUDA tensors")
    heads, d = _check(*tensors)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"launch_kda is built for head sizes {KERNEL_HEAD_DIMS}, got {d}")
    if state_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"launch_kda holds its state in float32 or bfloat16, not {state_dtype}")
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("f", f), ("beta", beta)):
        _check_operand(name, t, device, copied=name != "beta")
    b, s, width = q.shape
    if b > 65535 or heads > 65535:
        raise ValueError(f"launch_kda: at most 65,535 rows and heads, got {b}, {heads}")
    conv = [w.to(device, torch.bfloat16).contiguous() for w in (conv_q, conv_k, conv_v)]
    a_log = a_log.to(device, torch.float32).contiguous()
    dt_bias = dt_bias.to(device, torch.float32).contiguous()
    lengths = lengths.to(device, torch.int32).contiguous()
    out = torch.empty(b, s, width, dtype=q.dtype, device=device)
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = lib.mmg_kda(
            q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1), f.data_ptr(), f.stride(0), f.stride(1),
            beta.data_ptr(), beta.stride(0), beta.stride(1), conv[0].data_ptr(),
            conv[1].data_ptr(), conv[2].data_ptr(), a_log.data_ptr(), dt_bias.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, heads, s, d, int(reset_every),
            int(bool(head_decay)), int(state_dtype == torch.bfloat16), d ** -0.5, stream)
    check(lib, code, "kda")
    count_launch("kda")
    return out


def kda(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths, **variant):
    """The scan's output (module docstring).  CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version."""
    if q.is_cuda:
        return launch_kda(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths,
                          **variant)
    return plain_kda(q, k, v, f, beta, conv_q, conv_k, conv_v, a_log, dt_bias, lengths, **variant)

