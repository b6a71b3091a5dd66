"""The port's collectives over a mesh axis, one rank per process (gloo on the
CPU), against the rank-list plain versions and against ``jax.lax``'s
collectives under ``shard_map`` on the conftest's virtual devices.

Over 2 and 4 processes: ``all_gather`` (tiled and not), ``ppermute`` (a full
and a partial permutation), ``ring_all_gather`` (on CPU tensors the process
group's gather) and ``axis_index`` bit-equal; ``psum``, ``pmean`` and
``reduce_scatter`` (dims 0 and 1) within 1e-6 relative (gloo sums in its own
order); the gradients through ``all_gather``, ``psum`` and ``ppermute``
(their transposes) against JAX's; the global CLIP / MMGCLIP losses and
their gradients against the rank-list losses (which
tests/test_torch_parallel.py holds against JAX's) within 1e-6 relative /
1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mmgclip_tpu_torch.parallel import collectives as C
from torch_dist import run_ranks

REL = 1e-6
GRAD_ATOL = 1e-5
WORLDS = (2, 4)
SCALE = np.float32(1 / 0.07)


# the seeded inputs, defined once for this module and for the children (which import no JAX)
INPUTS = """
def inputs(world):
    rng = np.random.default_rng(world)
    unit = rng.standard_normal((3, 8 * world, 32)).astype(np.float32)
    return {"x": rng.standard_normal((world, 4, 6)).astype(np.float32),
            "y": rng.standard_normal((world, 4 * world, 3)).astype(np.float32),
            "z": rng.standard_normal((world, 3, 2 * world)).astype(np.float32),
            "w": rng.standard_normal((world, 4 * world, 6)).astype(np.float32),
            "emb": unit / np.linalg.norm(unit, axis=-1, keepdims=True)}
"""
exec(INPUTS)

BODY = INPUTS + """
from mmgclip_tpu_torch.parallel import collectives as C
from mmgclip_tpu_torch.parallel import global_clip_loss, global_mmgclip_loss
from mmgclip_tpu_torch.parallel.mesh import create_mesh
data = inputs(world)
mesh = create_mesh(data=world)
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
x = t(data["x"][rank])
res = {"axis_index": C.axis_index(mesh=mesh)}
res["all_gather"] = C.all_gather(x, mesh=mesh).numpy()
res["all_gather_untiled"] = C.all_gather(x, tiled=False, mesh=mesh).numpy()
res["ring"] = C.ring_all_gather(x, mesh=mesh).numpy()
res["psum"] = C.psum(x, mesh=mesh).numpy()
res["pmean"] = C.pmean(x, mesh=mesh).numpy()
res["reduce_scatter"] = C.reduce_scatter(t(data["y"][rank]), mesh=mesh).numpy()
res["reduce_scatter_dim1"] = C.reduce_scatter(t(data["z"][rank]), scatter_dimension=1, mesh=mesh).numpy()
res["ppermute"] = C.ppermute(x, [(i, (i + 1) % world) for i in range(world)], mesh=mesh).numpy()
res["ppermute_partial"] = C.ppermute(x, [(0, world - 1)], mesh=mesh).numpy()
grads = {}
for name, fn in (("all_gather", lambda v: (C.all_gather(v, mesh=mesh) * t(data["w"][rank])).sum()),
                 ("psum", lambda v: (C.psum(v, mesh=mesh) * t(data["x"][0])).sum()),
                 ("ppermute", lambda v: (C.ppermute(v, [(i, (i + 1) % world) for i in range(world)],
                                                    mesh=mesh) * t(data["x"][rank])).sum())):
    v = x.clone().requires_grad_()
    fn(v).backward()
    grads[name] = v.grad.numpy()
res["grads"] = grads
local = 8
emb = [t(data["emb"][k][rank * local:(rank + 1) * local]).requires_grad_() for k in range(3)]
for name, fn, k in (("clip", global_clip_loss, 2), ("mmgclip", global_mmgclip_loss, 3)):
    for e in emb:
        e.grad = None
    loss, labels = fn(*emb[:k], torch.tensor(SCALE), use_ring_gather=True, mesh=mesh)
    loss.backward()
    res[name] = (loss.item(), [e.grad.numpy().copy() for e in emb[:k]], labels.numpy())
save(res)
""".replace("SCALE", repr(float(SCALE)))


@functools.lru_cache(maxsize=None)
def port(world, tmp):
    import pathlib

    return run_ranks(world, BODY, pathlib.Path(tmp), name=f"pg{world}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {w: port(w, str(tmp_path_factory.mktemp(f"coll{w}"))) for w in WORLDS}


def jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def shard_map(world, fn, n_in=1, out=P("data")):
    return jax.shard_map(fn, mesh=jax_mesh(world), in_specs=(P("data"),) * n_in, out_specs=out,
                         check_vma=False)


@pytest.mark.parametrize("world", WORLDS)
def test_gathers_and_permutes_are_bit_equal(results, world):
    data, res = inputs(world), results[world]
    x = data["x"]
    flat = x.reshape(world * 4, 6)
    plain = C.all_gather([torch.from_numpy(a) for a in x])
    perm = [(i, (i + 1) % world) for i in range(world)]
    jax_perm = shard_map(world, lambda v: jax.lax.ppermute(v, "data", perm))(jnp.asarray(flat))
    jax_partial = shard_map(world, lambda v: jax.lax.ppermute(v, "data", [(0, world - 1)]))(jnp.asarray(flat))
    jax_gather = shard_map(world, lambda v: jax.lax.all_gather(v, "data", tiled=True))(jnp.asarray(flat))
    for r, got in enumerate(res):
        assert got["axis_index"] == r
        np.testing.assert_array_equal(got["all_gather"], plain[r].numpy())
        np.testing.assert_array_equal(got["all_gather"], np.asarray(jax_gather).reshape(world, -1, 6)[r])
        np.testing.assert_array_equal(got["all_gather_untiled"], x)
        np.testing.assert_array_equal(got["ring"], flat)
        np.testing.assert_array_equal(got["ppermute"], np.asarray(jax_perm).reshape(world, 4, 6)[r])
        np.testing.assert_array_equal(got["ppermute_partial"], np.asarray(jax_partial).reshape(world, 4, 6)[r])


@pytest.mark.parametrize("world", WORLDS)
def test_sums_match_the_plain_versions_and_jax(results, world):
    data, res = inputs(world), results[world]
    x = [torch.from_numpy(a) for a in data["x"]]
    jax_sum = shard_map(world, lambda v: jax.lax.psum(v, "data"), out=P())(
        jnp.asarray(data["x"].reshape(world * 4, 6)))
    scattered = C.reduce_scatter([torch.from_numpy(a) for a in data["y"]])
    jax_rs = shard_map(world, lambda v: jax.lax.psum_scatter(v, "data", scatter_dimension=0, tiled=True))(
        jnp.asarray(data["y"].reshape(world * 4 * world, 3)))
    z_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in data["z"]]
    dim1 = np.stack([a.numpy() for a in z_t]).sum(0)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["psum"], C.psum(x)[r].numpy(), rtol=REL, atol=REL)
        np.testing.assert_allclose(got["psum"], np.asarray(jax_sum), rtol=REL, atol=REL)
        np.testing.assert_allclose(got["pmean"], C.pmean(x)[r].numpy(), rtol=REL, atol=REL)
        np.testing.assert_allclose(got["reduce_scatter"], scattered[r].numpy(), rtol=REL, atol=REL)
        np.testing.assert_allclose(got["reduce_scatter"], np.asarray(jax_rs).reshape(world, 4, 3)[r],
                                   rtol=REL, atol=REL)
        np.testing.assert_allclose(got["reduce_scatter_dim1"], dim1[:, 2 * r:2 * r + 2], rtol=REL, atol=REL)


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_are_the_transposes(results, world):
    """JAX's gradients of the summed per-rank outputs: ``all_gather`` ->
    reduce-scatter, ``psum`` -> the cotangent as it is, ``ppermute`` -> the
    reverse rotation."""
    data, res = inputs(world), results[world]
    flat = jnp.asarray(data["x"].reshape(world * 4, 6))
    w = jnp.asarray(data["w"].reshape(world * 4 * world, 6))
    perm = [(i, (i + 1) % world) for i in range(world)]
    g_gather = jax.grad(lambda v: jnp.sum(shard_map(
        world, lambda a, b: jnp.sum(jax.lax.all_gather(a, "data", tiled=True) * b)[None], 2)(v, w)))(flat)
    g_psum = jax.grad(lambda v: jnp.sum(shard_map(
        world, lambda a: jax.lax.psum(a, "data"), out=P())(v) * jnp.asarray(data["x"][0])))(flat)
    g_perm = jax.grad(lambda v: jnp.sum(shard_map(
        world, lambda a: jax.lax.ppermute(a, "data", perm))(v) * flat))(flat)
    for r, got in enumerate(res):
        block = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(got["grads"]["all_gather"], np.asarray(g_gather)[block], rtol=REL, atol=REL)
        np.testing.assert_allclose(got["grads"]["psum"], np.asarray(g_psum)[block], rtol=REL, atol=REL)
        np.testing.assert_array_equal(got["grads"]["ppermute"], np.asarray(g_perm)[block])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["clip", "mmgclip"])
def test_global_losses_match_the_rank_lists(results, world, kind):
    """Across processes against the same loss over per-rank lists in one
    process (held against JAX's ring under ``shard_map`` in
    tests/test_torch_parallel.py)."""
    from mmgclip_tpu_torch.parallel import global_clip_loss, global_mmgclip_loss

    data, res = inputs(world), results[world]
    k = 2 if kind == "clip" else 3
    fn = global_clip_loss if kind == "clip" else global_mmgclip_loss
    shards = [[torch.from_numpy(data["emb"][i][8 * r:8 * r + 8]).requires_grad_() for r in range(world)]
              for i in range(k)]
    value, _labels = fn(*shards, torch.tensor(SCALE), use_ring_gather=True)
    value.backward()
    for r, got in enumerate(res):
        ours, our_grads, labels = got[kind]
        np.testing.assert_allclose(ours, value.item(), rtol=REL)
        np.testing.assert_array_equal(labels, r * 8 + np.arange(8))
        for a, rank_list in zip(our_grads, shards):
            np.testing.assert_allclose(a, rank_list[r].grad.numpy(), atol=GRAD_ATOL)
