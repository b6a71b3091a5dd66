"""The CLIP head, loss and optimizer, plain.

Linear bias-free projections, L2 normalisation, ``exp(logit_scale)``-scaled
cosine logits, zero-shot probabilities by softmax over the prompts, the
symmetric InfoNCE loss (Radford et al. 2021), and AdamW as optax's
``adamw`` applies it (Loshchilov and Hutter 2019): bias-corrected moments,
``eps`` outside the square root, decoupled decay on every trainable leaf.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def probabilities(image_feats, text_pooled, w_image, w_text, logit_scale) -> torch.Tensor:
    img = l2n(image_feats @ w_image)
    txt = l2n(text_pooled @ w_text)
    return torch.softmax(torch.exp(logit_scale) * img @ txt.T, dim=-1)


def clip_loss(image_emb: torch.Tensor, text_emb: torch.Tensor, logit_scale) -> torch.Tensor:
    logits = torch.exp(logit_scale) * image_emb @ text_emb.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g * g + B2 * self.nu[k]
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS) + self.wd * p
            p.sub_(self.lr * update)
