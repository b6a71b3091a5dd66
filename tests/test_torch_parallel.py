"""The port's collectives and global contrastive losses against the JAX
package's on the conftest's 8 virtual CPU devices.

The JAX side runs ``global_clip_loss`` / ``global_mmgclip_loss`` with
``use_ring_gather=True`` under ``shard_map``, where the Pallas ring runs in
interpret mode (as ``tests/test_collectives.py`` runs it); the port's side
holds the same rows as 8 per-rank tensors on the CPU, where the ring is its
plain version behind the same autograd function.  Loss within 1e-6
relative, gradients within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from mmgclip_tpu.parallel.contrastive import global_clip_loss as jax_global_clip_loss
from mmgclip_tpu.parallel.contrastive import global_mmgclip_loss as jax_global_mmgclip_loss
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.parallel import (
    all_gather,
    global_clip_loss,
    global_mmgclip_loss,
    pmean,
    psum,
    reduce_scatter,
    ring_all_gather,
    ring_all_gather_diff,
    ring_all_gather_plain,
)

RANKS = 8
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def jax_value_and_grads(fn, arrays, scale):
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    spec = PartitionSpec("data")

    def loss(*xs):
        return jax.shard_map(
            lambda *shards: fn(*shards, scale, axis_name="data", use_ring_gather=True)[0],
            mesh=mesh, in_specs=(spec,) * len(xs), out_specs=PartitionSpec(), check_vma=False,
        )(*xs)

    value, grads = jax.value_and_grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return float(value), [np.asarray(g) for g in grads]


def port_value_and_grads(fn, arrays, scale, use_ring):
    shards = [[torch.tensor(r).requires_grad_() for r in np.split(a, RANKS)] for a in arrays]
    loss, labels = fn(*shards, torch.tensor(scale), use_ring_gather=use_ring)
    loss.backward()
    local = arrays[0].shape[0] // RANKS
    for r, lab in enumerate(labels):
        np.testing.assert_array_equal(lab.numpy(), r * local + np.arange(local))
    return loss.item(), [torch.cat([t.grad for t in s]).numpy() for s in shards]


SCALE = np.float32(1 / 0.07)


@functools.lru_cache(maxsize=None)
def case(kind):
    """Seeded inputs of one loss and the JAX ring's value and gradients
    (interpret mode is slow: computed once per loss)."""
    rng = np.random.default_rng(0 if kind == "clip" else 1)
    local, d = 8, 128  # tiles onto (8, 128): the JAX side runs the Pallas kernel
    arrays = [unit_rows(rng, local * RANKS, d) for _ in range(2 if kind == "clip" else 3)]
    jax_fn = jax_global_clip_loss if kind == "clip" else jax_global_mmgclip_loss
    return arrays, jax_value_and_grads(jax_fn, arrays, SCALE)


@pytest.mark.parametrize("use_ring", [True, False])
@pytest.mark.parametrize("kind", ["clip", "mmgclip"])
def test_global_losses_match_jax_ring(kind, use_ring):
    arrays, (theirs, their_grads) = case(kind)
    port_fn = global_clip_loss if kind == "clip" else global_mmgclip_loss
    before = launch_counts()["ring_all_gather"]
    ours, our_grads = port_value_and_grads(port_fn, arrays, SCALE, use_ring)
    assert launch_counts()["ring_all_gather"] == before  # CPU tensors: the plain version
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    for a, b in zip(our_grads, their_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


def test_ring_diff_backward_matches_autograd_through_cat():
    rng = np.random.default_rng(2)
    rows = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(4)]
    weights = [torch.tensor(rng.standard_normal((12, 5)).astype(np.float32)) for _ in range(4)]
    ring = [torch.tensor(r, requires_grad=True) for r in rows]
    cat = [torch.tensor(r, requires_grad=True) for r in rows]
    sum((o * w).sum() for o, w in zip(ring_all_gather_diff(ring), weights)).backward()
    sum((torch.cat(cat) * w).sum() for w in weights).backward()
    for a, b in zip(ring, cat):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_plain_collectives_over_rank_lists():
    values = [torch.full((2, 3), float(r)) for r in range(4)]
    gathered = all_gather(values)
    assert len(gathered) == 4 and all(torch.equal(g, torch.cat(values)) for g in gathered)
    assert all(torch.equal(t, torch.full((2, 3), 6.0)) for t in psum(values))
    assert all(torch.equal(t, torch.full((2, 3), 1.5)) for t in pmean(values))
    scattered = reduce_scatter([torch.arange(8.0).reshape(8, 1) * (r + 1) for r in range(4)])
    assert [s.flatten().tolist() for s in scattered] == [[0, 10], [20, 30], [40, 50], [60, 70]]
    for out, ref in zip(ring_all_gather(values), ring_all_gather_plain(values)):
        assert torch.equal(out, ref) and torch.equal(out, torch.cat(values))


def test_check_ring_has_nothing_to_check_on_the_cpu():
    from mmgclip_tpu_torch.parallel import check_ring

    assert check_ring("cpu") is None
    assert check_ring(torch.device("cpu")) is None
