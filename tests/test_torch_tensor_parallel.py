"""Tensor parallelism for the frozen BERT tower
(``mmgclip_tpu_torch/parallel/tensor_parallel.py``) over 2 and 4 gloo
processes, against the JAX package's BERT on the same flax weights (tiny
BERT, 2 layers x 64, 4 heads): the Megatron layout's output within 1e-5,
each rank holding its block of heads and of the MLP's hidden units; the
specs cover the tower's tree as the JAX package's do.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmgclip_tpu.models.bert import BertConfig as JaxBertConfig
from mmgclip_tpu.models.bert import init_bert
from mmgclip_tpu.parallel.tensor_parallel import text_tower_specs as jax_specs
from mmgclip_tpu_torch.models.bert import BertConfig, BertEncoder
from mmgclip_tpu_torch.parallel.tensor_parallel import text_tower_specs
from torch_dist import run_ranks

TOL = 1e-5
CONFIG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=64)

BODY = """
from mmgclip_tpu_torch.models.bert import BertConfig, BertEncoder
from mmgclip_tpu_torch.parallel.mesh import create_mesh
from mmgclip_tpu_torch.parallel.tensor_parallel import shard_text_tower, tp_bert_forward
from mmgclip_tpu_torch.weights import load_flax_tree
with open(os.path.join(tmp, "..", "bert.pkl"), "rb") as fh:
    setup = pickle.load(fh)
mesh = create_mesh(data=1, model=world)
encoder = BertEncoder(BertConfig(**setup["config"]))
load_flax_tree(encoder, setup["params"])
shards = shard_text_tower(encoder, mesh)
out = tp_bert_forward(encoder, shards, torch.from_numpy(setup["ids"]), torch.from_numpy(setup["mask"]),
                      mesh=mesh)
save({"out": out.numpy(), "shapes": {k: tuple(v.shape) for k, v in shards.items()}})
"""


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    module, variables = init_bert(JaxBertConfig(**CONFIG), seed=0)
    ids = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.int64)
    mask[:, 12:] = 0
    expected = np.asarray(module.apply(variables, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    with open(root / "bert.pkl", "wb") as fh:
        pickle.dump({"params": params, "ids": ids, "mask": mask, "config": CONFIG}, fh)
    return root, expected


@pytest.mark.parametrize("world", [2, 4])
def test_tp_bert_matches_jax(bert, world):
    root, expected = bert
    sub = root / f"w{world}"
    sub.mkdir()
    ranks = run_ranks(world, BODY, sub)
    heads, inter = 4 // world, 128 // world
    for got in ranks:
        np.testing.assert_allclose(got["out"], expected, atol=TOL, rtol=TOL)
        assert got["shapes"]["qkv_kernel"] == (2, 64, 3, heads, 16)
        assert got["shapes"]["out_kernel"] == (2, heads * 16, 64)
        assert got["shapes"]["mlp_in_kernel"] == (2, 64, inter)
        assert got["shapes"]["mlp_out_kernel"] == (2, inter, 64)
        assert got["shapes"]["out_bias"] == (2, 64)


def test_tp_specs_cover_the_tower_and_match_jax():
    encoder = BertEncoder(BertConfig.tiny())
    ours = text_tower_specs()["params"]
    theirs = jax_specs()["params"]
    names = {name.split(".")[0] for name, _p in encoder.named_parameters()}
    assert names <= set(ours)
    for name, spec in ours.items():
        if isinstance(spec, dict):
            assert {k: tuple(v) for k, v in spec.items()} == {k: tuple(v) for k, v in theirs[name].items()}
        else:
            assert tuple(spec) == tuple(theirs[name]), name
