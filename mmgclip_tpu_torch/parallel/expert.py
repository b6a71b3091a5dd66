"""Expert parallelism: the MoE head's experts split over a mesh axis (port
of mmgclip_tpu/parallel/expert.py).

The MoE projection head (``models/projections.py::MoEProjectionHead``)
stacks its per-expert weights on a leading ``[E, ...]`` axis.
``shard_moe_params`` keeps on each rank only its ``E / size`` experts of
those leaves; the router stays whole, excluded by name as in the JAX
package (its ``[hidden, E]`` kernel would match the shape rule whenever
hidden == E).  ``expert_parallel_forward`` is the head's forward then: every
rank routes the whole batch (the router is replicated), runs its own experts
on their dispatched rows, and the experts' outputs are all-gathered over the
axis before the combine, so the result equals the replicated head.  The
gather's transpose (a reduce-scatter) returns each expert its gradient.

As with every replicated computation on the mesh, the loss is counted once:
divide it by the ranks that compute it, and sum the router's gradient (and
every other replicated parameter's) over them (``training/experiment.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch import nn

from .collectives import _all_gather_raw, all_gather
from .mesh import EXPERT_AXIS, Mesh, NamedSharding, PartitionSpec as P

_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def moe_param_specs(params: Dict[str, torch.Tensor], n_experts: int,
                    axis_name: str = EXPERT_AXIS) -> Dict[str, tuple]:
    """Placement specs of one MoE head's leaves (name -> spec): a leading
    ``[n_experts]`` axis splits over ``axis_name``; the router and anything
    else stays whole."""
    def spec(name, leaf):
        if name.split(".")[-1] == "router":
            return P()
        if leaf.dim() >= 1 and leaf.shape[0] == n_experts:
            return P(axis_name, *([None] * (leaf.dim() - 1)))
        return P()

    return {name: spec(name, leaf) for name, leaf in params.items()}


def shard_moe_params(head: nn.Module, mesh: Mesh, n_experts=None, axis_name: str = EXPERT_AXIS):
    """Keep this rank's experts of ``head`` (in place) and route its forward
    through ``expert_parallel_forward``."""
    n_experts = int(n_experts or head.n_experts)
    size = mesh.size(axis_name)
    if n_experts % size:
        raise ValueError(f"{n_experts} experts do not split over {size} ranks of {axis_name!r}")
    specs = moe_param_specs(dict(head.named_parameters()), n_experts, axis_name)
    for name, spec in specs.items():
        if spec == P():
            continue
        whole = getattr(head, name)
        block = whole.detach()[NamedSharding(mesh, spec).block(whole.shape)].clone()
        setattr(head, name, nn.Parameter(block, requires_grad=whole.requires_grad))
    head.expert_mesh, head.expert_axis = mesh, axis_name
    return head


def expert_parallel_forward(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The head's forward (before its dropout) with this rank's experts."""
    mesh, axis = head.expert_mesh, head.expert_axis
    local = head.w_in.shape[0]
    lo = mesh.index(axis) * local
    dispatch, combine = head.route(x)
    expert_out = head.experts(torch.einsum("nec,nh->ech", dispatch[:, lo:lo + local], x))
    return torch.einsum("nec,ecq->nq", combine, all_gather(expert_out, axis, mesh=mesh))


def expert_names(params: Dict[str, nn.Parameter], model: nn.Module) -> Dict[str, nn.Module]:
    """Dotted trainable names of split expert leaves -> their head."""
    out = {}
    for head_name in ("image_projection", "text_projection"):
        head = getattr(model, head_name, None)
        if head is not None and getattr(head, "expert_mesh", None) is not None:
            for leaf in _EXPERT_LEAVES:
                out[f"{head_name}.{leaf}"] = head
    return {k: v for k, v in out.items() if k in params}


def gather_experts(t: torch.Tensor, head: nn.Module) -> torch.Tensor:
    """Every rank's block of an expert leaf (or its moment) -> the whole."""
    return _all_gather_raw(t.detach().contiguous(), head.expert_mesh, head.expert_axis)


def expert_block(t: torch.Tensor, head: nn.Module) -> torch.Tensor:
    """This rank's block of a whole expert leaf (or moment)."""
    local = t.shape[0] // head.expert_mesh.size(head.expert_axis)
    return t[head.expert_mesh.index(head.expert_axis) * local:][:local].clone()


@contextlib.contextmanager
def full_experts(model: nn.Module) -> Iterator[None]:
    """Inside, every split head holds all of its experts and runs replicated
    (a collective on entry); on exit each rank keeps its block of what the
    leaves then hold (a checkpoint just loaded, say)."""
    heads = [getattr(model, n, None) for n in ("image_projection", "text_projection")]
    heads = [h for h in heads if h is not None and getattr(h, "expert_mesh", None) is not None]
    saved = []
    for head in heads:
        blocks = {leaf: getattr(head, leaf) for leaf in _EXPERT_LEAVES}
        for leaf, param in blocks.items():
            setattr(head, leaf, nn.Parameter(gather_experts(param, head), requires_grad=False))
        saved.append((head, blocks, head.expert_mesh))
        head.expert_mesh = None
    try:
        yield
    finally:
        for head, blocks, mesh in saved:
            head.expert_mesh = mesh
            with torch.no_grad():
                for leaf, param in blocks.items():
                    param.copy_(expert_block(getattr(head, leaf).detach(), head))
                    setattr(head, leaf, param)
