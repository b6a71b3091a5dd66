"""Expert parallelism (``mmgclip_tpu_torch/parallel/expert.py``) over 2 and 4
gloo processes, against the replicated head and against the JAX package's
expert-parallel setup (``tests/test_expert.py:152-192``: n = 16, h = 16,
p = 8, E = 8, flax's init).

Each rank keeps E / P experts of the ``[E, ...]`` leaves (the router whole,
by name); the head's output and every gradient (the router's summed over
the ranks, each expert's on the rank that holds it) equal the replicated
head's and JAX's within 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.models.projections import MoEProjectionHead as JaxMoE
from mmgclip_tpu_torch.models.projections import MoEProjectionHead
from mmgclip_tpu_torch.parallel.expert import moe_param_specs
from mmgclip_tpu_torch.parallel.mesh import EXPERT_AXIS
from mmgclip_tpu_torch.weights import load_flax_tree
from torch_dist import run_ranks

TOL = 1e-6
N, H, P_DIM, E = 16, 16, 8, 8

BODY = """
from mmgclip_tpu_torch.models.projections import MoEProjectionHead
from mmgclip_tpu_torch.parallel.expert import shard_moe_params
from mmgclip_tpu_torch.parallel.mesh import EXPERT_AXIS, create_mesh
from mmgclip_tpu_torch.weights import load_flax_tree
with open(os.path.join(tmp, "..", "jax_head.pkl"), "rb") as fh:
    setup = pickle.load(fh)
mesh = create_mesh(data=1, model=world, axis_names=("data", EXPERT_AXIS))
head = MoEProjectionHead(16, 8, 0.0, n_experts=8, capacity_factor=100.0)
load_flax_tree(head, setup["params"])
shard_moe_params(head, mesh)
x = torch.from_numpy(setup["x"])
y = head(x)
(((y ** 2).sum()) / world).backward()  # the replicated loss, counted once over the ranks
router = head.router.grad.clone()
torch.distributed.all_reduce(router)
save({"y": y.detach().numpy(), "router": router.numpy(),
      "grads": {k: getattr(head, k).grad.numpy() for k in ("w_in", "b_in", "w_out", "b_out")},
      "shapes": {k: tuple(v.shape) for k, v in head.named_parameters()}})
"""


@pytest.fixture(scope="module")
def jax_head(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep")
    head = JaxMoE(embedding_dim=H, projection_dim=P_DIM, n_experts=E, capacity_factor=100.0)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(N, H)), jnp.float32)
    variables = head.init(jax.random.key(0), x)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    y = np.asarray(head.apply(variables, x))
    grads = jax.grad(lambda p: jnp.sum(head.apply({"params": p}, x) ** 2))(variables["params"])
    with open(root / "jax_head.pkl", "wb") as fh:
        pickle.dump({"params": params, "x": np.asarray(x)}, fh)
    return root, params, np.asarray(x), y, jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_matches_replicated_and_jax(jax_head, world):
    root, params, x, y, grads = jax_head
    sub = root / f"w{world}"
    sub.mkdir()
    ranks = run_ranks(world, BODY, sub)
    replicated = MoEProjectionHead(H, P_DIM, 0.0, n_experts=E, capacity_factor=100.0)
    load_flax_tree(replicated, params)
    out = replicated(torch.from_numpy(x))
    (out ** 2).sum().backward()
    local = E // world
    for rank, got in enumerate(ranks):
        assert got["shapes"]["w_in"] == (local, H, P_DIM) and got["shapes"]["router"] == (H, E)
        np.testing.assert_allclose(got["y"], out.detach().numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["y"], y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["router"], replicated.router.grad.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["router"], grads["router"], rtol=TOL, atol=TOL)
        block = slice(rank * local, (rank + 1) * local)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, getattr(replicated, k).grad.numpy()[block], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(g, grads[k][block], rtol=TOL, atol=TOL)


def test_specs_exclude_the_router_by_name():
    """hidden == E: the router's [hidden, E] kernel would match the shape
    rule; it stays whole, as in the JAX package."""
    head = MoEProjectionHead(8, 4, 0.0, n_experts=8)
    specs = moe_param_specs(dict(head.named_parameters()), 8)
    assert specs["router"] == ()
    assert specs["w_in"] == (EXPERT_AXIS, None, None) and specs["b_out"] == (EXPERT_AXIS, None)
