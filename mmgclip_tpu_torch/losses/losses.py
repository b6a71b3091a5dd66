"""Contrastive losses in PyTorch (port of mmgclip_tpu/losses/losses.py).

Reference semantics (reference: mmgclip/loss/losses.py:6-216):

* CLIPLoss — symmetric cross-entropy over [n, n] logits, labels arange(n).
* MMGCLIPLoss — CLIP term recomputed from embeddings plus a text-to-text
  (report vs impression) term, total = clip + 0.5 * t2t.
* AveragedMedicalCLIPLoss — greedy clustering of near-duplicate texts, then
  CE over cluster-averaged logit columns (unused columns are -inf).  The
  greedy scan is n small tensor ops on the embeddings' device, so the loss
  never reads back to the host.

Every function accepts the model-output dict via ``**kwargs`` so
``loss_fn(**outputs)`` works like the reference's ``criterion(**outputs)``.
"""

from __future__ import annotations

from functools import partial

import torch

from ..config.registry import LOSSES


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels; -inf-masked columns take no mass."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels[:, None])[:, 0].mean()


@LOSSES.register("CLIPLoss")
def clip_loss(logits_per_image, logits_per_text, **_):
    """Symmetric InfoNCE (reference: losses.py:28-44)."""
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    loss_i = _cross_entropy(logits_per_image, labels)
    loss_t = _cross_entropy(logits_per_text, labels)
    return (loss_i + loss_t) / 2.0, labels


@LOSSES.register("MMGCLIPLoss")
def mmgclip_loss(image_embeddings, text_embeddings, text_embeddings2, logit_scale,
                 t2t_weight: float = 0.5, **_):
    """CXR-CLIP-style loss: CLIP + weighted T2T term (reference: losses.py:46-96)."""
    labels = torch.arange(image_embeddings.shape[0], device=image_embeddings.device)
    logits_per_image = logit_scale * image_embeddings @ text_embeddings.T
    logits_per_text = logit_scale * text_embeddings @ image_embeddings.T
    loss_clip = (_cross_entropy(logits_per_image, labels)
                 + _cross_entropy(logits_per_text, labels)) / 2.0
    logits_t2t1 = logit_scale * text_embeddings2 @ text_embeddings.T
    logits_t1t2 = logit_scale * text_embeddings @ text_embeddings2.T
    loss_t2t = (_cross_entropy(logits_t2t1, labels) + _cross_entropy(logits_t1t2, labels)) / 2.0
    return loss_clip + t2t_weight * loss_t2t, labels


def assign_similarity_labels(cosine_sim: torch.Tensor, threshold: float = 0.65) -> torch.Tensor:
    """Greedy duplicate-text clustering (reference: losses.py:121-162).

    Scanning rows in order, an unlabeled row becomes a new cluster leader and
    claims every later unlabeled row whose similarity meets the threshold.
    Labels are dense 0..k-1 in leader scan order (the forward CE indexes
    columns of the full [n, n] text-logit matrix with them)."""
    n = cosine_sim.shape[0]
    device = cosine_sim.device
    leader = torch.full((n,), -1, dtype=torch.long, device=device)
    rows = torch.arange(n, device=device)
    for i in range(n):
        is_leader = leader[i] < 0
        claim = is_leader & (leader < 0) & (cosine_sim[i] >= threshold)
        leader = torch.where(claim | (is_leader & (rows == i)), torch.full_like(leader, i), leader)
    # leader -> dense rank by discovery order
    dense_of_row = torch.cumsum((leader == rows).long(), 0) - 1
    return dense_of_row[leader]


def average_logits_by_label(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Column-average logits over clusters; invalid columns -> -inf.

    Column c of the [n, n] result is the mean of the columns with
    label == c (reference: losses.py:164-186)."""
    n = logits.shape[1]
    membership = (labels[None, :] == torch.arange(n, device=logits.device)[:, None]).to(logits.dtype)
    counts = membership.sum(dim=1)
    averaged = (logits @ membership.T) / torch.clamp(counts, min=1.0)[None, :]
    return torch.where(counts[None, :] > 0, averaged, torch.full_like(averaged, float("-inf")))


@LOSSES.register("AveragedMedicalCLIPLoss")
def averaged_medical_clip_loss(image_embeddings, text_embeddings, logit_scale, logits_per_image,
                               logits_per_text, similarity_threshold: float = 0.65, **_):
    """CE over duplicate-averaged logit columns (reference: losses.py:98-216)."""
    sims = text_embeddings @ text_embeddings.T
    norms = torch.linalg.norm(text_embeddings, dim=-1, keepdim=True)
    sims = sims / torch.clamp(norms * norms.T, min=1e-12)
    labels = assign_similarity_labels(sims, similarity_threshold)
    averaged_per_image = average_logits_by_label(logits_per_image, labels)
    loss_i = _cross_entropy(averaged_per_image, labels)
    loss_t = _cross_entropy(logits_per_text, labels)
    return (loss_i + loss_t) / 2.0, labels


def create_loss(name: str, **kwargs):
    """Name -> loss callable (reference: loss_controller.py:3-23)."""
    fn = LOSSES.get(name)
    return partial(fn, **kwargs) if kwargs else fn
