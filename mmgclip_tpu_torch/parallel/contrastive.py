"""Global-batch contrastive losses (port of
mmgclip_tpu/parallel/contrastive.py).

Each rank holds a shard of the batch, gathers the L2-normalized embeddings
of every rank and computes cross-entropy of its local rows against the
**global** column set, with labels offset by ``rank * local_n``; the loss is
the mean over ranks.  Gradients flow back to every rank's shard through the
gather's transpose (a reduce-scatter).  Two forms, as in ``collectives``:

* tensors: this process's shard, the gathers over ``axis_name`` of the mesh
  (a name, or a ``(slice, data)`` tuple), the mean by ``pmean``;
* lists: element r is rank r's shard, all in one process.

``use_ring_gather`` routes the gathers through ``ring_all_gather_diff`` (two
for CLIP, four for MMGCLIP, as the JAX package does; single-axis only), else
through the plain ``all_gather``: the same values and gradients.  The
ring's protocol is checked once per loss (``check_ring``), after all of its
gathers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..losses.losses import _cross_entropy
from .collectives import all_gather, check_ring, pmean, ring_all_gather_diff
from .mesh import DATA_AXIS, Mesh, current_mesh


def _local_labels(ranks: int, local_n: int, device) -> List[torch.Tensor]:
    return [r * local_n + torch.arange(local_n, device=device) for r in range(ranks)]


def _clip_term(image_embeddings, text_embeddings, logit_scale, gather):
    all_image = gather(image_embeddings)  # per rank: [global_n, d]
    all_text = gather(text_embeddings)
    labels = _local_labels(len(image_embeddings), image_embeddings[0].shape[0],
                           image_embeddings[0].device)
    losses = []
    for r, lab in enumerate(labels):
        logits_i = logit_scale * image_embeddings[r] @ all_text[r].T  # [local_n, global_n]
        logits_t = logit_scale * text_embeddings[r] @ all_image[r].T
        losses.append((_cross_entropy(logits_i, lab) + _cross_entropy(logits_t, lab)) / 2.0)
    return pmean(losses)[0], labels


def _mesh_gather(axis_name, mesh: Mesh, use_ring: bool):
    if use_ring and isinstance(axis_name, str):
        return lambda t: ring_all_gather_diff(t, axis_name, mesh=mesh)
    return lambda t: all_gather(t, axis_name, mesh=mesh)


def _mesh_clip_term(image_embeddings, text_embeddings, logit_scale, axis_name, mesh, gather):
    local_n = image_embeddings.shape[0]
    all_image = gather(image_embeddings)  # [global_n, d]
    all_text = gather(text_embeddings)
    logits_i = logit_scale * image_embeddings @ all_text.T  # [local_n, global_n]
    logits_t = logit_scale * text_embeddings @ all_image.T
    labels = mesh.index(axis_name) * local_n + torch.arange(local_n, device=image_embeddings.device)
    loss = (_cross_entropy(logits_i, labels) + _cross_entropy(logits_t, labels)) / 2.0
    return pmean(loss, axis_name, mesh=mesh), labels


def global_clip_loss(image_embeddings, text_embeddings, logit_scale, axis_name=DATA_AXIS,
                     use_ring_gather: bool = False, *, mesh: Optional[Mesh] = None):
    """Symmetric InfoNCE against the gathered global batch.  Embeddings are
    this rank's ``[local_n, d]`` shard (tensors) or every rank's (lists),
    already L2-normalized.  Returns the mean loss over ranks (what every rank
    holds after JAX's pmean) and the labels (per rank for lists)."""
    if isinstance(image_embeddings, (list, tuple)):
        return _list_clip_loss(image_embeddings, text_embeddings, logit_scale, use_ring_gather)
    mesh = mesh or current_mesh()
    gather = _mesh_gather(axis_name, mesh, use_ring_gather)
    loss, labels = _mesh_clip_term(image_embeddings, text_embeddings, logit_scale, axis_name,
                                   mesh, gather)
    if use_ring_gather:
        check_ring(image_embeddings.device)
    return loss, labels


def global_mmgclip_loss(image_embeddings, text_embeddings, text_embeddings2, logit_scale,
                        t2t_weight: float = 0.5, axis_name=DATA_AXIS, use_ring_gather: bool = False,
                        *, mesh: Optional[Mesh] = None):
    """Global-batch MMGCLIPLoss: CLIP term + text-to-text impression term;
    ``use_ring_gather`` routes all four gathers through the ring."""
    if isinstance(image_embeddings, (list, tuple)):
        return _list_mmgclip_loss(image_embeddings, text_embeddings, text_embeddings2, logit_scale,
                                  t2t_weight, use_ring_gather)
    mesh = mesh or current_mesh()
    gather = _mesh_gather(axis_name, mesh, use_ring_gather)
    clip_term, labels = _mesh_clip_term(image_embeddings, text_embeddings, logit_scale, axis_name,
                                        mesh, gather)
    all_text = gather(text_embeddings)
    all_text2 = gather(text_embeddings2)
    logits_t2t1 = logit_scale * text_embeddings2 @ all_text.T
    logits_t1t2 = logit_scale * text_embeddings @ all_text2.T
    t2t = (_cross_entropy(logits_t2t1, labels) + _cross_entropy(logits_t1t2, labels)) / 2.0
    if use_ring_gather:
        check_ring(image_embeddings.device)
    return clip_term + t2t_weight * pmean(t2t, axis_name, mesh=mesh), labels


def _list_clip_loss(image_embeddings: Sequence[torch.Tensor], text_embeddings: Sequence[torch.Tensor],
                    logit_scale, use_ring_gather: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    gather = ring_all_gather_diff if use_ring_gather else all_gather
    loss, labels = _clip_term(image_embeddings, text_embeddings, logit_scale, gather)
    if use_ring_gather:
        check_ring(image_embeddings[0].device)
    return loss, labels


def _list_mmgclip_loss(image_embeddings: Sequence[torch.Tensor], text_embeddings: Sequence[torch.Tensor],
                       text_embeddings2: Sequence[torch.Tensor], logit_scale, t2t_weight: float,
                       use_ring_gather: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    gather = ring_all_gather_diff if use_ring_gather else all_gather
    clip_term, labels = _clip_term(image_embeddings, text_embeddings, logit_scale, gather)
    all_text = gather(text_embeddings)
    all_text2 = gather(text_embeddings2)
    t2t = []
    for r, lab in enumerate(labels):
        logits_t2t1 = logit_scale * text_embeddings2[r] @ all_text[r].T
        logits_t1t2 = logit_scale * text_embeddings[r] @ all_text2[r].T
        t2t.append((_cross_entropy(logits_t2t1, lab) + _cross_entropy(logits_t1t2, lab)) / 2.0)
    if use_ring_gather:
        check_ring(image_embeddings[0].device)
    return clip_term + t2t_weight * pmean(t2t)[0], labels
