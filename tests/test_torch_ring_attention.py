"""Ring attention (``mmgclip_tpu_torch/ops/ring_attention.py``) over 2 and 4
gloo processes, the sequence split across them, against the JAX package's
ring attention and full attention (``tests/test_ring_attention.py``'s
cases, with and without the padding mask): within 2e-5, JAX's own bound.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from mmgclip_tpu.ops.flash_attention import attention_reference
from mmgclip_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from torch_dist import run_ranks

TOL = 2e-5
CASES = {"full": ((2, 4, 64, 16), None), "masked": ((1, 2, 32, 8), 24)}

BODY = """
from mmgclip_tpu_torch.ops.ring_attention import ring_attention
from mmgclip_tpu_torch.parallel.mesh import create_mesh
with open(os.path.join(tmp, "..", "qkv.pkl"), "rb") as fh:
    cases = pickle.load(fh)
mesh = create_mesh(data=world, axis_names=("seq", "model"))
res = {}
for name, (q, k, v, mask) in cases.items():
    s = q.shape[2] // world
    block = slice(rank * s, (rank + 1) * s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, :, block]))
    kv_valid = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask[:, block]))
    res[name] = ring_attention(t(q), t(k), t(v), "seq", kv_valid=kv_valid, mesh=mesh).numpy()
save(res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring_attention")
    cases, expected = {}, {}
    for seed, (name, (shape, cut)) in enumerate(CASES.items()):
        rng = np.random.default_rng(seed)
        q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
        mask = None
        if cut is not None:
            mask = np.ones((shape[0], shape[2]), np.int32)
            mask[:, cut:] = 0
        cases[name] = (q, k, v, mask)
        expected[name] = np.asarray(attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                                        None if mask is None else jnp.asarray(mask)))
    with open(root / "qkv.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    out = {}
    for world in (2, 4):
        sub = root / f"w{world}"
        sub.mkdir()
        out[world] = run_ranks(world, BODY, sub)
    return cases, expected, out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_attention_matches_full_attention_and_jax(runs, world, name):
    cases, expected, out = runs
    q, k, v, mask = cases[name]
    s = q.shape[2] // world
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    spec, mspec = P(None, None, "seq", None), P(None, "seq")
    if mask is None:
        jax_out = jax.shard_map(lambda a, b, c: jax_ring_attention(a, b, c, axis_name="seq"), mesh=mesh,
                                in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
    else:
        jax_out = jax.shard_map(lambda a, b, c, m: jax_ring_attention(a, b, c, axis_name="seq", kv_valid=m),
                                mesh=mesh, in_specs=(spec,) * 3 + (mspec,), out_specs=spec)(q, k, v, mask)
    for rank, got in enumerate(out[world]):
        block = slice(rank * s, (rank + 1) * s)
        np.testing.assert_allclose(got[name], expected[name][:, :, block], atol=TOL)
        np.testing.assert_allclose(got[name], np.asarray(jax_out)[:, :, block], atol=TOL)
