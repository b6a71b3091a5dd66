"""Collectives and the global contrastive loss over per-rank tensor lists
(the single-process counterpart of the JAX package's ``shard_map`` code)."""

from .collectives import (
    all_gather,
    check_ring,
    launch_ring_all_gather,
    pmean,
    psum,
    reduce_scatter,
    ring_all_gather,
    ring_all_gather_diff,
    ring_all_gather_plain,
)
from .contrastive import global_clip_loss, global_mmgclip_loss

__all__ = [
    "all_gather",
    "check_ring",
    "global_clip_loss",
    "global_mmgclip_loss",
    "launch_ring_all_gather",
    "pmean",
    "psum",
    "reduce_scatter",
    "ring_all_gather",
    "ring_all_gather_diff",
    "ring_all_gather_plain",
]
