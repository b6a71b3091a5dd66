"""Tensor parallelism for the frozen BERT tower over the ``model`` axis (port
of mmgclip_tpu/parallel/tensor_parallel.py).

The Megatron layout of the JAX package's specs: QKV and the first MLP
matrix split over their output (whole heads, hidden units), the attention
output and the second MLP matrix over their input, so each block needs one
all-reduce after each row-parallel product (``bert_layer``'s ``reduce``),
before its bias.  Each rank holds whole heads, so attention runs per rank
on its heads, through the flash kernel where the tower enables it.  The
embeddings are looked up whole on every rank (three table lookups and a
LayerNorm), as the pipelined forward does.  The result equals the plain
tower up to the order of the partial sums.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .collectives import psum
from .mesh import MODEL_AXIS, Mesh, NamedSharding, PartitionSpec as P, current_mesh


def text_tower_specs() -> dict:
    """Placement specs of ``BertEncoder``'s stacked tree (leading axis =
    layers, never split), by parameter name."""
    return {
        "params": {
            "word_embeddings": {"embedding": P(None, MODEL_AXIS)},
            "position_embeddings": {"embedding": P(None, MODEL_AXIS)},
            "token_type_embeddings": {"embedding": P(None, MODEL_AXIS)},
            "embeddings_norm": {"scale": P(), "bias": P()},
            # column-parallel: whole heads of [L, H, 3, heads, dh]
            "qkv_kernel": P(None, None, None, MODEL_AXIS, None),
            "qkv_bias": P(None, None, MODEL_AXIS, None),
            # row-parallel: split input features (all-reduce after)
            "out_kernel": P(None, MODEL_AXIS, None),
            "out_bias": P(),
            "attn_norm_scale": P(),
            "attn_norm_bias": P(),
            "mlp_in_kernel": P(None, None, MODEL_AXIS),
            "mlp_in_bias": P(None, MODEL_AXIS),
            "mlp_out_kernel": P(None, MODEL_AXIS, None),
            "mlp_out_bias": P(),
            "out_norm_scale": P(),
            "out_norm_bias": P(),
        }
    }


def shard_text_tower(encoder, mesh: Optional[Mesh] = None, axis_name: str = MODEL_AXIS
                     ) -> Dict[str, torch.Tensor]:
    """This rank's block of every stacked leaf of a ``BertEncoder``, by name."""
    from ..models.bert import STACKED

    mesh = mesh or current_mesh()
    specs = text_tower_specs()["params"]
    out = {}
    for name in STACKED:
        spec = tuple(axis_name if a == MODEL_AXIS else a for a in specs[name])
        leaf = getattr(encoder, name).detach()
        out[name] = leaf[NamedSharding(mesh, spec).block(leaf.shape)].contiguous()
    return out


@torch.no_grad()
def tp_bert_forward(encoder, shards: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    token_type_ids: Optional[torch.Tensor] = None, *, mesh: Optional[Mesh] = None,
                    axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """``encoder(input_ids, attention_mask, token_type_ids)`` with the layer
    stack in the Megatron layout: ``shards`` from ``shard_text_tower``."""
    from ..models.bert import bert_layer

    mesh = mesh or current_mesh()
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
    hidden = encoder.embed(input_ids, token_type_ids)
    attend = encoder._attention(attention_mask, input_ids.shape[1])

    def reduce(t):
        return psum(t, axis_name, mesh=mesh)

    for i in range(encoder.config.num_hidden_layers):
        hidden = bert_layer(hidden, {k: v[i] for k, v in shards.items()}, attend, encoder.config,
                            reduce=reduce)
    return hidden
