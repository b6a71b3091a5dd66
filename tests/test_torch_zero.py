"""ZeRO-1 (``mmgclip_tpu_torch/parallel/zero.py``) over 2 gloo processes
against the replicated AdamW and against the JAX package.

* which leaves split, and on which axis: the JAX package's ``zero1_shardings``
  rule (``_leaf_spec``) leaf by leaf;
* one ZeRO-1 step from per-rank gradients equals the replicated AdamW step
  on their sum within 1e-6, with each rank holding only its block of the
  split moments;
* checkpoints cross both ways: the ZeRO run's file (whole moments) loads
  into the unsharded port AdamW and into JAX's ``load_checkpoint`` (optax's
  layout) within 1e-6, and a JAX-written file loads into ZeRO-1, each rank
  keeping its block.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.parallel.zero import _leaf_spec
from mmgclip_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from mmgclip_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from mmgclip_tpu.training.optim import create_optimizer as jax_create_optimizer
from mmgclip_tpu_torch.parallel.zero import _leaf_axis
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.training.optim import AdamW
from mmgclip_tpu_torch.weights import flatten_tree
from torch_dist import run_ranks

LR, WD = 1e-3, 0.1
TOL = 1e-6

SETUP = """
def setup():
    rng = np.random.default_rng(0)
    shapes = {"head.kernel": (6, 4), "head.bias": (4,), "odd.kernel": (3, 5), "logit_scale": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(2)]
    return params, grads
"""
exec(SETUP)

BODY = SETUP + """
from mmgclip_tpu_torch.parallel.mesh import create_mesh
from mmgclip_tpu_torch.parallel.zero import ZeroAdamW, opt_state_bytes_per_device
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
mesh = create_mesh(data=world)
params, grads = setup()
live = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
opt = ZeroAdamW(live, 1e-3, 0.1, mesh)
for step in range(2):
    for k, p in live.items():
        p.grad = torch.tensor(grads[rank][k]) * (step + 1)
    opt.step()
state = opt.state_dict()
if rank == 0:
    nested = {}
    for k, v in live.items():
        head, *leaf = k.split(".")
        if leaf:
            nested.setdefault(head, {})[leaf[0]] = v.detach().numpy()
        else:
            nested[head] = v.detach().numpy()
    save_checkpoint(os.path.join(tmp, "zero.ckpt"), nested, state, epoch=1)
torch.distributed.barrier()
fresh = ZeroAdamW({k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}, 1e-3, 0.1, mesh)
fresh.load_state_dict(load_checkpoint(os.path.join(tmp, "jax.ckpt"))["opt_state"])
save({"params": {k: v.detach().numpy() for k, v in live.items()}, "state": state,
      "shapes": {k: tuple(v.shape) for k, v in opt.mu.items()}, "sharded": opt.sharded_names(),
      "bytes": opt_state_bytes_per_device(opt),
      "loaded": {k: v.numpy() for k, v in fresh.mu.items()}, "count": int(fresh.count)})
"""


def replicated_step():
    params, grads = setup()
    live = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = AdamW(live, LR, WD)
    for step in range(2):
        for k, p in live.items():
            p.grad = (torch.tensor(grads[0][k]) + torch.tensor(grads[1][k])) * (step + 1)
        opt.step()
    return live, opt


def jax_state():
    """JAX's AdamW two steps on the summed gradients, as optax holds it."""
    params, grads = setup()
    nest = lambda flat: {k.split(".")[0]: {} for k in flat}  # noqa: E731
    tree = nest(params)
    for k, v in params.items():
        head, *rest = k.split(".")
        if rest:
            tree[head][rest[0]] = jnp.asarray(v)
        else:
            tree[head] = jnp.asarray(v)
    tx = jax_create_optimizer(LR, WD)
    state = tx.init(tree)
    for step in range(2):
        g = jax.tree_util.tree_map(jnp.zeros_like, tree)
        for k in params:
            head, *rest = k.split(".")
            value = jnp.asarray((grads[0][k] + grads[1][k]) * (step + 1))
            if rest:
                g[head][rest[0]] = value
            else:
                g[head] = value
        updates, state = tx.update(g, state, tree)
        tree = jax.tree_util.tree_map(lambda p, u: p + u, tree, updates)
    return tree, state, tx


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    tree, state, _tx = jax_state()
    jax_save_checkpoint(str(tmp / "jax.ckpt"), tree, state, epoch=1)
    return tmp, run_ranks(2, BODY, tmp)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_axes_follow_the_jax_rule(n):
    params, _ = setup()
    for name, value in params.items():
        spec = tuple(_leaf_spec(jnp.asarray(value), n))
        axis = _leaf_axis(value.shape, n)
        expected = None if not spec else len(spec) - 1
        assert axis == expected, (name, n, spec)


def test_one_step_equals_the_replicated_step(run):
    _tmp, ranks = run
    live, opt = replicated_step()
    whole = opt.state_dict()
    for got in ranks:
        for k, p in live.items():
            np.testing.assert_allclose(got["params"][k], p.detach().numpy(), rtol=TOL, atol=TOL, err_msg=k)
        for slot in ("mu", "nu"):
            for k in whole[slot]:
                np.testing.assert_allclose(got["state"][slot][k], whole[slot][k], rtol=TOL, atol=TOL)
        assert int(got["state"]["count"]) == 2


def test_the_moments_are_really_sharded(run):
    _tmp, ranks = run
    for got in ranks:
        assert got["sharded"] == ["head.bias", "head.kernel"]
        assert got["shapes"] == {"head.kernel": (3, 4), "head.bias": (2,), "odd.kernel": (3, 5),
                                 "logit_scale": ()}
    whole = (6 * 4 + 4 + 3 * 5 + 1) * 2 * 4
    assert ranks[0]["bytes"] == (3 * 4 + 2 + 3 * 5 + 1) * 2 * 4 < whole


def test_checkpoints_cross_with_unsharded_runs_and_jax(run):
    tmp, ranks = run
    path = str(tmp / "zero.ckpt")
    live, opt = replicated_step()
    # the unsharded port optimizer reads the ZeRO file
    fresh = AdamW({k: torch.nn.Parameter(v.detach().clone()) for k, v in live.items()}, LR, WD)
    fresh.load_state_dict(load_checkpoint(path)["opt_state"])
    for k in opt.mu:
        np.testing.assert_allclose(fresh.mu[k].numpy(), opt.mu[k].numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(fresh.nu[k].numpy(), opt.nu[k].numpy(), rtol=TOL, atol=TOL)
    # JAX reads it in optax's layout
    tree, state, tx = jax_state()
    loaded = jax_load_checkpoint(path, tree, tx.init(tree))
    theirs = flatten_tree(jax.device_get(loaded["opt_state"].inner_state[0].mu))
    ours = flatten_tree(jax.device_get(state.inner_state[0].mu))
    for k in ours:
        np.testing.assert_allclose(theirs[k], ours[k], rtol=TOL, atol=TOL)
    # and ZeRO-1 reads JAX's file, each rank keeping its block
    jax_mu = flatten_tree(jax.device_get(state.inner_state[0].mu))
    for rank, got in enumerate(ranks):
        assert got["count"] == 2
        np.testing.assert_allclose(got["loaded"]["head.kernel"], jax_mu["head.kernel"][3 * rank:3 * rank + 3],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["loaded"]["odd.kernel"], jax_mu["odd.kernel"], rtol=TOL, atol=TOL)
    with open(path, "rb") as fh:
        assert pickle.load(fh)["epoch"] == 1
