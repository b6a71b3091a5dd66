"""The port's mesh (``mmgclip_tpu_torch/parallel/mesh.py``) against the JAX
package's on the conftest's 8 virtual devices.

Rank r of the port stands where device r stands in JAX's mesh: for every
mesh shape (the [data, model] mesh, the multislice [slice, data, model]
mesh) and every placement family the trainer uses, the block of a global
array that rank r holds (``NamedSharding.block``, the rows of
``batch_sharding``) equals the index JAX's ``NamedSharding`` gives device r.
Each check views the mesh as rank r in one process (no process group).
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from mmgclip_tpu.parallel import mesh as jax_mesh
from mmgclip_tpu_torch.parallel import mesh as M

SHAPE = (16, 24)


def jax_blocks(mesh, spec, shape=SHAPE):
    """device id -> index tuple (slices normalised to (start, stop))."""
    index = JaxNamedSharding(mesh, spec).devices_indices_map(shape)
    return {d.id: tuple((s.start or 0, s.stop if s.stop is not None else n)
                        for s, n in zip(idx, shape)) for d, idx in index.items()}


def port_block(mesh, spec, shape=SHAPE):
    return tuple((s.start or 0, s.stop if s.stop is not None else n)
                 for s, n in zip(M.NamedSharding(mesh, spec).block(shape), shape))


def port_spec(spec):
    return M.PartitionSpec(*spec)


SPECS = [(), (M.DATA_AXIS,), (M.MODEL_AXIS,), (None, M.DATA_AXIS), ((M.DATA_AXIS, M.MODEL_AXIS),)]


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_mesh_blocks_match_jax(data, model, spec):
    jmesh = jax_mesh.create_mesh(data=data, model=model)
    theirs = jax_blocks(jmesh, JaxP(*spec))
    for rank in range(data * model):
        ours = M.create_mesh(data=data, model=model, ranks=range(8), rank=rank)
        assert ours.shape == dict(jmesh.shape)
        assert port_block(ours, port_spec(spec)) == theirs[rank], (rank, spec)


@pytest.mark.parametrize("slices,data,model", [(2, 2, 2), (2, 4, 1), (4, 1, 2)])
def test_multislice_batch_rows_match_jax(slices, data, model):
    jmesh = jax_mesh.create_multislice_mesh(slices, data=data, model=model)
    theirs = jax_blocks(jmesh, jax_mesh.batch_sharding(jmesh).spec, (32,))
    for rank in range(8):
        ours = M.create_multislice_mesh(slices, data=data, model=model, ranks=range(8), rank=rank)
        assert ours.shape == dict(jmesh.shape)
        rows = M.batch_rows(ours, 32)
        assert (rows.start, rows.stop) == theirs[rank][0], rank
        assert ours.index((M.SLICE_AXIS, M.DATA_AXIS)) == rows.start // (32 // (slices * data))


def test_batch_sharding_and_helpers_match_jax():
    jmesh = jax_mesh.create_mesh(data=4, model=2)
    assert tuple(jax_mesh.batch_sharding(jmesh).spec) == (M.DATA_AXIS,)
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for rank in range(8):
        mesh = M.create_mesh(data=4, model=2, ranks=range(8), rank=rank)
        assert M.batch_sharding(mesh).spec == (M.DATA_AXIS,)
        rows = M.shard_batch(mesh, {"a": x, "b": [x]})
        start = (rank // 2) * 4
        np.testing.assert_array_equal(rows["a"], x[start:start + 4])
        np.testing.assert_array_equal(rows["b"][0], x[start:start + 4])
        assert M.replicate(mesh, x) is x or np.array_equal(M.replicate(mesh, x), x)


def test_mesh_errors_match_jax():
    for port, theirs in ((lambda: M.create_mesh(data=3, model=2, ranks=range(8)),
                          lambda: jax_mesh.create_mesh(data=3, model=2)),
                         (lambda: M.create_multislice_mesh(3, data=2, model=2, ranks=range(8)),
                          lambda: jax_mesh.create_multislice_mesh(3, data=2, model=2))):
        with pytest.raises(ValueError) as ours:
            port()
        with pytest.raises(ValueError) as jaxs:
            theirs()
        assert str(ours.value) == str(jaxs.value)


def test_one_rank_without_a_process_group_is_the_identity():
    mesh = M.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.member and mesh.group("data") is None
    x = np.ones((5, 2))
    assert M.shard_batch(mesh, x).shape == (5, 2)
    assert M.batch_rows(mesh, 5) == slice(0, 5)


def test_axis_names_are_jax_s():
    for name in ("DATA_AXIS", "MODEL_AXIS", "SLICE_AXIS", "PIPE_AXIS", "EXPERT_AXIS"):
        assert getattr(M, name) == getattr(jax_mesh, name)
    assert len(jax.devices()) == 8
