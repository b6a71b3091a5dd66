from .losses import (
    assign_similarity_labels,
    average_logits_by_label,
    averaged_medical_clip_loss,
    clip_loss,
    create_loss,
    mmgclip_loss,
)

__all__ = [
    "assign_similarity_labels",
    "average_logits_by_label",
    "averaged_medical_clip_loss",
    "clip_loss",
    "create_loss",
    "mmgclip_loss",
]
