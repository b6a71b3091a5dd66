"""Pipeline parallelism over stacked layers (port of
mmgclip_tpu/parallel/pipeline.py).

The GPipe schedule of the JAX package: the stacked layer parameters
(``[L, ...]``, the layout ``models/bert.py`` keeps) split their leading axis
over the ``pipe`` ranks, the batch splits into M microbatches, and at every
one of the M + S - 1 steps stage 0 takes the next microbatch, each stage
runs its L / S layers, the last stage records the microbatch that finished,
and the states move one stage on (``ppermute``, a send and a receive between
stage ranks).  The recorded outputs are summed over the stages (only the
last one wrote any), so every rank ends with the whole result.  Each
collective is differentiable (``ppermute``'s backward is the reverse
rotation), so the pipeline has a backward too: the bubble fraction is
(S - 1) / (M + S - 1).  The result equals the plain loop over all layers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from .collectives import ppermute, psum
from .mesh import PIPE_AXIS, Mesh, NamedSharding, PartitionSpec as P, current_mesh


def _as_tuple(state):
    return state if isinstance(state, tuple) else (state,)


def _like(state, template):
    return state if isinstance(template, tuple) else state[0]


def pipeline_spmd(layer_fn: Callable, local_params: Dict[str, torch.Tensor], microbatches,
                  *, mesh: Optional[Mesh] = None, axis_name: str = PIPE_AXIS, remat: bool = False):
    """This stage's program.  ``layer_fn(state, p)`` applies one layer (``p``:
    one layer's slice of ``local_params``) to one microbatch's state (a
    tensor or a tuple of tensors); ``local_params`` holds this stage's
    ``[L/S, ...]`` layers; ``microbatches`` is ``[M, mb, ...]`` (or a tuple of
    such), the same on every stage.  Returns the ``[M, mb, ...]`` last-layer
    states on every rank."""
    mesh = mesh or current_mesh()
    n_stages, stage = mesh.size(axis_name), mesh.index(axis_name)
    micro = _as_tuple(microbatches)
    n_micro = micro[0].shape[0]
    n_local = next(iter(local_params.values())).shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def layer(state, i):
        return _as_tuple(layer_fn(_like(state, microbatches), {k: v[i] for k, v in local_params.items()}))

    def run_local(state):
        for i in range(n_local):
            if remat:
                state = torch.utils.checkpoint.checkpoint(layer, state, i, use_reentrant=False)
            else:
                state = layer(state, i)
        return state

    # the selections are ``where``s, as in the JAX program, not branches: every
    # rank's autograd graph then holds every step's ppermute, so the backward
    # runs the same collectives in the same order on every stage
    device = micro[0].device
    first = torch.tensor(stage == 0, device=device)
    state = tuple(torch.zeros_like(x[0]) for x in micro)
    outputs = [tuple(torch.zeros_like(x[0]) for x in micro) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (steps past M re-ingest the last one,
        # which never reaches the last stage inside the loop: the drain bubble)
        state = tuple(torch.where(first, x[min(t, n_micro - 1)], s) for x, s in zip(micro, state))
        state = run_local(state)
        index = min(max(t - (n_stages - 1), 0), n_micro - 1)
        take = torch.tensor(stage == n_stages - 1 and t >= n_stages - 1, device=device)
        outputs[index] = tuple(torch.where(take, s, o) for s, o in zip(state, outputs[index]))
        state = tuple(ppermute(x, perm, axis_name, mesh=mesh) for x in state)
    # only the last stage recorded anything: the sum gives every rank the result
    stacked = tuple(psum(torch.stack([out[j] for out in outputs]), axis_name, mesh=mesh)
                    for j in range(len(micro)))
    return _like(stacked, microbatches)


def stacked_layer_specs(stacked_params: Dict[str, torch.Tensor], axis_name: str = PIPE_AXIS):
    """Specs splitting every leaf's leading (layer) axis over the pipe axis."""
    return {k: P(axis_name, *([None] * (v.dim() - 1))) for k, v in stacked_params.items()}


def pipeline_forward(layer_fn: Callable, stacked_params: Dict[str, torch.Tensor], state,
                     mesh: Optional[Mesh] = None, *, axis_name: str = PIPE_AXIS,
                     num_microbatches: Optional[int] = None, remat: bool = False):
    """``state`` through all L stacked layers, pipelined over ``axis_name``;
    equals applying ``layer_fn`` for every layer in order.  ``state``'s
    leaves share a leading batch axis that the microbatch count (default:
    the stage count) divides."""
    mesh = mesh or current_mesh()
    n_stages = mesh.size(axis_name)
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} stages")
    n_micro = int(num_microbatches or n_stages)
    leaves = _as_tuple(state)
    batch = leaves[0].shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} microbatches")
    specs = stacked_layer_specs(stacked_params, axis_name)
    local = {k: v[NamedSharding(mesh, specs[k]).block(v.shape)] for k, v in stacked_params.items()}
    micro = tuple(x.reshape(n_micro, batch // n_micro, *x.shape[1:]) for x in leaves)
    out = _as_tuple(pipeline_spmd(layer_fn, local, _like(micro, state), mesh=mesh,
                                  axis_name=axis_name, remat=remat))
    return _like(tuple(x.reshape(batch, *x.shape[2:]) for x in out), state)


def pipelined_bert_forward(encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                           mesh: Optional[Mesh] = None, *, token_type_ids=None,
                           axis_name: str = PIPE_AXIS, num_microbatches: Optional[int] = None,
                           remat: bool = False) -> torch.Tensor:
    """``BertEncoder`` forward with the layer stack pipelined: the
    embeddings whole on every rank, then ``bert_layer`` per stage."""
    from ..models.bert import STACKED, bert_layer

    hidden = encoder.embed(input_ids, token_type_ids)
    stacked = {k: getattr(encoder, k) for k in STACKED}

    def layer_fn(state, p):
        h, mask = state
        return bert_layer(h, p, encoder._attention(mask, h.shape[1]), encoder.config), mask

    out, _mask = pipeline_forward(layer_fn, stacked, (hidden, attention_mask), mesh,
                                  axis_name=axis_name, num_microbatches=num_microbatches,
                                  remat=remat)
    return out
