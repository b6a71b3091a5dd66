"""Ring attention: attention over a sequence sharded across ranks (port of
mmgclip_tpu/ops/ring_attention.py).

Each rank holds the Q, K and V blocks of its stretch of the sequence; it
attends its queries to the K/V block it holds, then passes K, V and their
validity mask one rank on (``ppermute``) while it carries the online-softmax
statistics, so after as many steps as ranks every query has seen the whole
sequence and no rank held the [s, s] scores or all of K and V.  The JAX
package writes it as an XLA ring (no ``pallas_call``), so it stays plain
torch around the collective here; the local block is a plain product.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import ppermute
from ..parallel.mesh import Mesh, current_mesh

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str,
                   kv_valid: Optional[torch.Tensor] = None, *, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """q, k, v: this rank's ``[b, h, s_local, d]`` blocks; kv_valid: its
    ``[b, s_local]`` validity mask (default all valid).  Returns this rank's
    ``[b, h, s_local, d]`` block of attention over the whole sequence."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis_name)
    b, h, s_local, d = q.shape
    qf = q.float() * (1.0 / d ** 0.5)
    if kv_valid is None:
        kv_valid = torch.ones((b, s_local), dtype=torch.int32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk, valid = k, v, kv_valid
    m = torch.full((b, h, s_local, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    for step in range(n):
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        scores = torch.where(valid[:, None, None, :] > 0, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
        m = m_new
        if step < n - 1:  # the last rotation would only bring back this rank's own block
            k_blk = ppermute(k_blk, perm, axis_name, mesh=mesh)
            v_blk = ppermute(v_blk, perm, axis_name, mesh=mesh)
            valid = ppermute(valid, perm, axis_name, mesh=mesh)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
