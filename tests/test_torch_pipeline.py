"""Pipeline parallelism (``mmgclip_tpu_torch/parallel/pipeline.py``) over 2
and 4 gloo processes, one stage each, against the JAX package's pipeline
(``tests/test_pipeline.py``'s cases: stages / layers / microbatches (2, 4, 2),
(4, 8, 4), (4, 8, 8), a tuple state, the pipelined BERT and the backward)
on the same inputs: within 1e-5 (1e-6 where JAX's own test holds it).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmgclip_tpu.models.bert import BertConfig as JaxBertConfig
from mmgclip_tpu.models.bert import init_bert
from mmgclip_tpu_torch.parallel.mesh import create_mesh
from mmgclip_tpu_torch.parallel.pipeline import pipeline_forward
from torch_dist import run_ranks

CASES = [(2, 4, 2), (4, 8, 4), (4, 8, 8)]
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64)

SETUP = """
def stacked_mlp(n_layers, width, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(scale=0.3, size=(n_layers, width, width)).astype(np.float32),
            "b": rng.normal(scale=0.1, size=(n_layers, width)).astype(np.float32)}

def inputs(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)
"""
exec(SETUP)

BODY = SETUP + """
from mmgclip_tpu_torch.models.bert import BertConfig, BertEncoder
from mmgclip_tpu_torch.parallel.mesh import create_mesh
from mmgclip_tpu_torch.parallel.pipeline import pipeline_forward, pipelined_bert_forward
from mmgclip_tpu_torch.weights import load_flax_tree
mesh = create_mesh(data=1, model=world, axis_names=("data", "pipe"))
t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
layer = lambda h, p: torch.tanh(h @ p["w"] + p["b"])
res = {}
for stages, n_layers, n_micro in CASES:
    if stages != world:
        continue
    stacked = t(stacked_mlp(n_layers, 16))
    res[(stages, n_layers, n_micro)] = pipeline_forward(
        layer, stacked, torch.from_numpy(inputs(1, (8, 16))), mesh, num_microbatches=n_micro).numpy()
if world == 2:
    stacked = t(stacked_mlp(4, 8, seed=2))
    scale = torch.tensor([1.0, 0.5, 2.0, 1.5])
    got, got_scale = pipeline_forward(lambda s, p: (layer(s[0], p) * s[1][:, None], s[1]), stacked,
                                      (torch.from_numpy(inputs(3, (4, 8))), scale), mesh)
    res["tuple"] = (got.numpy(), got_scale.numpy())
if world == 4:
    with open(os.path.join(tmp, "..", "bert.pkl"), "rb") as fh:
        setup = pickle.load(fh)
    encoder = BertEncoder(BertConfig(**setup["config"]))
    load_flax_tree(encoder, setup["params"])
    with torch.no_grad():
        res["bert"] = pipelined_bert_forward(encoder, torch.from_numpy(setup["ids"]),
                                             torch.from_numpy(setup["mask"]), mesh,
                                             num_microbatches=4).numpy()
    params = {k: v.requires_grad_() for k, v in t(stacked_mlp(8, 16, seed=4)).items()}
    out = pipeline_forward(layer, params, torch.from_numpy(inputs(5, (8, 16))), mesh)
    # every stage computes the loss from the summed result; psum's transpose
    # hands each the cotangent as it is, and only the last stage's records
    # lead back into the layers, so the loss counts once
    (out ** 2).sum().backward()
    res["grads"] = {k: v.grad.numpy() for k, v in params.items()}
save(res)
""".replace("CASES", repr(CASES))


def jax_scan(layer, stacked, x):
    return jax.lax.scan(lambda h, p: (layer(h, p), None), x, stacked)[0]


def jax_layer(h, p):
    return jnp.tanh(h @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    module, variables = init_bert(JaxBertConfig(**BERT), seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(8, 16)).astype(np.int64)
    lengths = rng.integers(4, 17, size=8)
    mask = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int64)
    expected = np.asarray(module.apply(variables, jnp.asarray(ids), jnp.asarray(mask)))
    with open(root / "bert.pkl", "wb") as fh:
        pickle.dump({"params": jax.tree_util.tree_map(np.asarray, variables["params"]), "ids": ids,
                     "mask": mask, "config": BERT}, fh)
    out = {}
    for world in (2, 4):
        sub = root / f"w{world}"
        sub.mkdir()
        out[world] = run_ranks(world, BODY, sub)
    return out, expected


@pytest.mark.parametrize("stages,n_layers,n_micro", CASES)
def test_pipeline_equals_sequential_scan(runs, stages, n_layers, n_micro):
    ranks, _ = runs
    stacked = {k: jnp.asarray(v) for k, v in stacked_mlp(n_layers, 16).items()}
    expected = np.asarray(jax_scan(jax_layer, stacked, jnp.asarray(inputs(1, (8, 16)))))
    for got in ranks[stages]:
        np.testing.assert_allclose(got[(stages, n_layers, n_micro)], expected, rtol=1e-6, atol=1e-6)


def test_pipeline_tuple_state(runs):
    ranks, _ = runs
    stacked = {k: jnp.asarray(v) for k, v in stacked_mlp(4, 8, seed=2).items()}
    scale = jnp.asarray([1.0, 0.5, 2.0, 1.5], jnp.float32)
    expected = jax.lax.scan(lambda s, p: ((jax_layer(s[0], p) * s[1][:, None], s[1]), None),
                            (jnp.asarray(inputs(3, (4, 8))), scale), stacked)[0][0]
    for got in ranks[2]:
        np.testing.assert_allclose(got["tuple"][0], np.asarray(expected), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["tuple"][1], np.asarray(scale))


def test_pipelined_bert_matches_jax(runs):
    ranks, expected = runs
    for got in ranks[4]:
        np.testing.assert_allclose(got["bert"], expected, rtol=2e-5, atol=2e-5)


def test_pipeline_backward_matches_sequential(runs):
    ranks, _ = runs
    stacked = {k: jnp.asarray(v) for k, v in stacked_mlp(8, 16, seed=4).items()}
    x = jnp.asarray(inputs(5, (8, 16)))
    grads = jax.grad(lambda p: jnp.sum(jax_scan(jax_layer, p, x) ** 2))(stacked)
    for stage, got in enumerate(ranks[4]):
        for k in grads:
            # every stage holds the whole tree here; only its own two layers get a gradient
            own = np.zeros(8, bool)
            own[2 * stage:2 * stage + 2] = True
            assert np.abs(got["grads"][k][~own]).max() == 0 and np.abs(got["grads"][k][own]).max() > 0
    summed = {k: sum(r["grads"][k] for r in ranks[4]) for k in grads}
    for k in grads:
        np.testing.assert_allclose(summed[k], np.asarray(grads[k]), rtol=1e-5, atol=1e-5)


def test_pipeline_rejects_bad_splits():
    import torch

    stacked = {k: torch.from_numpy(v) for k, v in stacked_mlp(4, 8).items()}
    x = torch.zeros((4, 8))
    three = create_mesh(data=1, model=3, ranks=range(3), axis_names=("data", "pipe"), rank=0)
    with pytest.raises(ValueError, match="layers"):
        pipeline_forward(lambda h, p: h, stacked, x, three)
    two = create_mesh(data=1, model=2, ranks=range(2), axis_names=("data", "pipe"), rank=0)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(lambda h, p: h, stacked, x, two, num_microbatches=3)
