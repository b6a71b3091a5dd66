"""A named mesh over the ranks of a ``torch.distributed`` process group
(port of mmgclip_tpu/parallel/mesh.py).

The JAX package lays devices out as a named ``jax.sharding.Mesh`` and places
arrays with ``NamedSharding``; here every rank is one process (one card in a
real node, or one of several processes sharing a card) and the mesh names
the ranks: ``create_mesh(data, model)`` reshapes the rank list to
``[data, model]``, ``create_multislice_mesh`` to ``[slice, data, model]``.
For every axis (and the ``(slice, data)`` batch axis) the mesh holds one
process sub-group per line of ranks along it, built in the same order on
every rank as ``torch.distributed.new_group`` requires.

A ``NamedSharding(mesh, spec)`` is a placement: ``spec`` names, per
dimension, the mesh axis (or tuple of axes) that dimension is split over,
``None`` for a whole dimension.  ``put_global(value, sharding)`` returns the
block of a process-identical value that this rank holds, the counterpart of
``jax.make_array_from_process_local_data``'s target-array mode;
``shard_batch`` keeps this rank's rows along (slice, data) and ``replicate``
the whole value.  With one rank and no process group every helper is the
identity, so single-process paths run exactly as before.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"  # the axis between slices (hosts, or NVLink domains)
PIPE_AXIS = "pipe"  # pipeline stages (parallel/pipeline.py)
EXPERT_AXIS = "expert"  # MoE experts (parallel/expert.py)

AxisName = Union[str, Tuple[str, ...]]

_CURRENT: Optional["Mesh"] = None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


class Mesh:
    """Ranks laid out on named axes.  ``ranks`` is the array of global ranks
    (shape = the axis sizes); ranks of the world outside it take no part."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str], rank: Optional[int] = None):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d rank array for axes {tuple(axis_names)}")
        self.devices = ranks  # the JAX name: the mesh's array of members
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        # ``rank``: view the mesh as another rank (the layout alone; no groups
        # are built without a process group)
        self.rank = process_index() if rank is None else int(rank)
        where = np.argwhere(ranks == self.rank)
        self.member = len(where) == 1
        self.coords: Dict[str, int] = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                                       if self.member else {})
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._group_ranks: Dict[Tuple[str, ...], list] = {}
        self._build_groups()

    # ------------------------------------------------------------------
    def _axes(self, axis: AxisName) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for name in axes:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return axes

    def _lines(self, axes: Tuple[str, ...]):
        """Every line of ranks along ``axes`` (the other axes fixed), each in
        the linear order of ``axes``."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        moved = np.moveaxis(self.devices, dims + rest, list(range(len(self.axis_names))))
        flat = moved.reshape(int(np.prod([self.devices.shape[d] for d in dims])), -1)
        return [flat[:, j].tolist() for j in range(flat.shape[1])]

    def _build_groups(self) -> None:
        dist = _dist()
        combos = [(a,) for a in self.axis_names]
        if SLICE_AXIS in self.shape and DATA_AXIS in self.shape:
            combos.append((SLICE_AXIS, DATA_AXIS))
        combos.append(self.axis_names)
        for axes in combos:
            for line in self._lines(axes):
                # every rank creates every group, in one order (new_group is collective)
                group = dist.new_group(line) if dist is not None and len(line) > 1 else None
                if self.rank in line:
                    self._groups[axes] = group
                    self._group_ranks[axes] = line

    # ------------------------------------------------------------------
    def size(self, axis: AxisName) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))

    def index(self, axis: AxisName) -> int:
        """This rank's linear index along ``axis`` (a name or a tuple of names)."""
        index = 0
        for name in self._axes(axis):
            index = index * self.shape[name] + self.coords[name]
        return index

    def group(self, axis: AxisName):
        """The process sub-group of this rank's line along ``axis``; None when
        the line is this rank alone."""
        return self._groups.get(self._axes(axis))

    def group_ranks(self, axis: AxisName) -> list:
        """Global ranks of this rank's line along ``axis``, in axis order."""
        return list(self._group_ranks[self._axes(axis)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def current_mesh() -> Mesh:
    """The mesh that collectives over an axis name use when given none: the
    last one created, else a one-rank data mesh."""
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = create_mesh(data=1, model=1, ranks=[process_index()])
    return _CURRENT


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = mesh


def create_mesh(data: Optional[int] = None, model: int = 1, ranks: Optional[Sequence[int]] = None,
                axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS), rank: Optional[int] = None) -> Mesh:
    """A [data, model] mesh over ``ranks`` (default: every rank of the world)."""
    ranks = list(ranks if ranks is not None else range(world_size()))
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"Mesh {data}x{model} does not match {n} devices")
    mesh = Mesh(np.asarray(ranks).reshape(data, model), axis_names, rank)
    set_mesh(mesh)
    return mesh


def create_multislice_mesh(n_slices: int, data: Optional[int] = None, model: int = 1,
                           ranks: Optional[Sequence[int]] = None, rank: Optional[int] = None) -> Mesh:
    """[slice, data, model] mesh: consecutive ranks share a slice, as
    ``jax.devices()`` order puts a slice's devices together."""
    ranks = list(ranks if ranks is not None else range(world_size()))
    per_slice = len(ranks) // n_slices
    if data is None:
        data = per_slice // model
    if n_slices * data * model != len(ranks):
        raise ValueError(f"Mesh {n_slices}x{data}x{model} does not match {len(ranks)} devices")
    mesh = Mesh(np.asarray(ranks).reshape(n_slices, data, model), (SLICE_AXIS, DATA_AXIS, MODEL_AXIS), rank)
    set_mesh(mesh)
    return mesh


def PartitionSpec(*dims) -> tuple:  # noqa: N802 - the JAX name
    """A placement spec: per dimension an axis name, a tuple of names, or None."""
    return tuple(dims)


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple = ()

    def block(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's index block of a global array of ``shape``."""
        index = []
        for dim, size in enumerate(shape):
            axes = self.spec[dim] if dim < len(self.spec) else None
            if axes is None:
                index.append(slice(None))
                continue
            parts = self.mesh.size(axes)
            if size % parts:
                raise ValueError(f"dimension {dim} of size {size} does not split over {axes} "
                                 f"({parts} parts)")
            step = size // parts
            start = self.mesh.index(axes) * step
            index.append(slice(start, start + step))
        return tuple(index)


def batch_axes(mesh: Mesh) -> AxisName:
    """The axes the batch splits over: (slice, data), or data alone."""
    axes = tuple(a for a in (SLICE_AXIS, DATA_AXIS) if a in mesh.shape)
    return axes if len(axes) > 1 else axes[0]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the slice and data axes (DP)."""
    return NamedSharding(mesh, PartitionSpec(batch_axes(mesh)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (a slice along dim 0)."""
    return batch_sharding(mesh).block((n,))[0]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree if tree is None else fn(tree)


def put_global(tree, sharding: NamedSharding):
    """This rank's block of every leaf of a process-identical tree (numpy
    arrays or tensors): the whole leaf for a replicated spec."""
    return _tree_map(lambda x: x[sharding.block(x.shape)], tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every leaf's batch axis."""
    return put_global(tree, batch_sharding(mesh))


def replicate(mesh: Mesh, tree):
    return put_global(tree, replicated(mesh))


__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SLICE_AXIS", "PIPE_AXIS", "EXPERT_AXIS", "Mesh", "NamedSharding",
    "PartitionSpec", "batch_axes", "batch_rows", "batch_sharding", "create_mesh",
    "create_multislice_mesh", "current_mesh", "process_index", "put_global",
    "replicate", "replicated", "set_mesh", "shard_batch", "world_size",
]
