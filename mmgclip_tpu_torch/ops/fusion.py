"""Study-level view fusion (port of mmgclip_tpu/ops/fusion.py).

Fuses per-view 768-d feature vectors into one study vector with a reduction
over the view axis.
"""

from __future__ import annotations

import torch

FUSION_METHODS = ("maxpool", "avgpool", "stack", "concat")


def fuse_views(view_features: torch.Tensor, method: str = "avgpool") -> torch.Tensor:
    """view_features: [n_views, d] (or [b, n_views, d]) -> fused features."""
    axis = view_features.dim() - 2
    if method == "maxpool":
        return view_features.amax(dim=axis)
    if method == "avgpool":
        return view_features.mean(dim=axis)
    if method == "stack":
        return view_features
    if method == "concat":
        return view_features.reshape(*view_features.shape[:axis], -1)
    raise ValueError(f"Unknown fusion method {method!r}; one of {FUSION_METHODS}")
