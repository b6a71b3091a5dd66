"""Global-batch contrastive losses over per-rank lists (port of
mmgclip_tpu/parallel/contrastive.py).

Each rank holds a shard of the batch (element r of each list), gathers the
L2-normalized embeddings of every rank and computes cross-entropy of its
local rows against the **global** column set, with labels offset by
``r * local_n``; the loss is the mean over ranks.  Gradients flow back to
every rank's shard through the gather's transpose (a reduce-scatter).

``use_ring_gather`` routes the gathers through ``ring_all_gather_diff`` (two
for CLIP, four for MMGCLIP, as the JAX package does), else through the plain
``all_gather``: the same values and gradients.  The ring's protocol error
word is read once per loss (``check_ring``), after all of its gathers.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..losses.losses import _cross_entropy
from .collectives import all_gather, check_ring, pmean, ring_all_gather_diff


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


def global_clip_loss(image_embeddings: Sequence[torch.Tensor], text_embeddings: Sequence[torch.Tensor],
                     logit_scale, use_ring_gather: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Symmetric InfoNCE against the gathered global batch.  Embeddings are
    per-rank [local_n, d] shards, already L2-normalized.  Returns the mean
    loss over ranks (what every rank holds after JAX's pmean) and the
    per-rank labels."""
    gather = ring_all_gather_diff if use_ring_gather else all_gather
    loss, labels = _clip_term(image_embeddings, text_embeddings, logit_scale, gather)
    if use_ring_gather:
        check_ring(image_embeddings[0].device)
    return loss, labels


def global_mmgclip_loss(image_embeddings: Sequence[torch.Tensor], text_embeddings: Sequence[torch.Tensor],
                        text_embeddings2: Sequence[torch.Tensor], logit_scale, t2t_weight: float = 0.5,
                        use_ring_gather: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Global-batch MMGCLIPLoss: CLIP term + text-to-text impression term;
    ``use_ring_gather`` routes all four gathers through the ring."""
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
