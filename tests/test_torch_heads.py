"""The remaining projection heads and ``PromptClassifier`` against the JAX
package's, on parameters carried across with ``mmgclip_tpu_torch.weights``.

* ``ProjectionHead`` (Dense / BatchNorm / ReLU): eval mode on the stored
  statistics, train mode on batch statistics (dropout 0), and its running
  statistics unchanged after a train step, as the JAX CLIP model discards
  the update;
* ``MoEProjectionHead``: Switch top-1 routing, including a batch that
  overflows the experts' capacity (dropped rows exactly zero in both);
* ``PromptClassifier`` over a CLIP model with a tiny BERT: probabilities,
  the first image's argmax (quirk Q10) and the per-image list, and the
  prompt cache dropped when the parameters are swapped or updated in place.

Tolerance 1e-5 (fp32, summation order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu.models.clip import PromptClassifier as JaxPromptClassifier
from mmgclip_tpu.models.projections import MoEProjectionHead as JaxMoE
from mmgclip_tpu.models.projections import ProjectionHead as JaxProjectionHead
from mmgclip_tpu_torch.config import compose
from mmgclip_tpu_torch.data.tokenizer import Tokenizer
from mmgclip_tpu_torch.models.clip import MMGCLIP, PromptClassifier
from mmgclip_tpu_torch.models.projections import MoEProjectionHead, ProjectionHead
from mmgclip_tpu_torch.training.optim import AdamW
from mmgclip_tpu_torch.weights import load_clip_params, load_flax_tree, load_head_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL = 1e-5


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def features(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def bn_head():
    x = features((6, 12), 0)
    jhead = JaxProjectionHead(embedding_dim=12, hidden_dims=(10, 8), projection_dim=6, dropout=0.0)
    variables = host(jhead.init(jax.random.key(1), jnp.asarray(x)))
    head = ProjectionHead(12, 6, 0.0, hidden_dims=(10, 8))
    load_flax_tree(head, variables["params"])
    load_head_state(head, {"batch_stats": variables["batch_stats"]})
    return jhead, variables, head


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_projection_head_matches_jax(bn_head, train):
    jhead, variables, head = bn_head
    x = features((7, 12), 2)
    if train:  # batch statistics; the stats update is discarded, as the JAX CLIP model does
        ref, _updates = jhead.apply(variables, jnp.asarray(x), deterministic=False,
                                    mutable=["batch_stats"])
    else:
        ref = jhead.apply(variables, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        out = head(torch.from_numpy(x), train=train).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


def test_projection_head_statistics_stay_after_a_train_step(bn_head):
    _jhead, variables, head = bn_head
    before = {k: v.clone() for k, v in head.named_buffers()}
    params = dict(head.named_parameters())
    kernel = params["hidden_0.kernel"].detach().clone()
    optimizer = AdamW(params, 1e-2, 1e-4)
    optimizer.zero_grad()
    head(torch.from_numpy(features((9, 12), 3)), train=True).square().mean().backward()
    optimizer.step()
    assert not torch.equal(params["hidden_0.kernel"], kernel)  # the step moved the weights
    for name, buffer in head.named_buffers():
        assert torch.equal(buffer, before[name]), name
    np.testing.assert_array_equal(head.bn_0.var.numpy(), variables["batch_stats"]["bn_0"]["var"])


def test_head_state_must_match_the_buffers(bn_head):
    _jhead, variables, head = bn_head
    stats = dict(variables["batch_stats"])
    stats.pop("bn_1")
    with pytest.raises(KeyError, match="head state"):
        load_head_state(head, {"batch_stats": stats})


@pytest.mark.parametrize("n,capacity_factor", [(12, 2.0), (16, 0.5)], ids=["fits", "overflows"])
def test_moe_head_matches_jax(n, capacity_factor):
    x = features((n, 12), 4)
    jhead = JaxMoE(embedding_dim=12, projection_dim=6, n_experts=4, capacity_factor=capacity_factor)
    variables = host(jhead.init(jax.random.key(5), jnp.asarray(x)))
    ref = np.asarray(jhead.apply(variables, jnp.asarray(x), deterministic=True))
    head = MoEProjectionHead(12, 6, 0.0, n_experts=4, capacity_factor=capacity_factor)
    load_flax_tree(head, variables["params"])
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    dropped = np.all(ref == 0, axis=1)
    np.testing.assert_array_equal(np.all(out == 0, axis=1), dropped)
    if capacity_factor < 1:  # capacity 2 of 16 rows over 4 experts
        assert dropped.any(), "the batch must overflow the experts' capacity"


# ----------------------------------------------------------------------
# PromptClassifier

TEXT = ("{vocab_size: 4096, hidden_size: 64, num_hidden_layers: 2, num_attention_heads: 4, "
        "intermediate_size: 128, max_position_embeddings: 64}")
PROMPTS = ["Mass shape is oval.", "Mass shape is round.", "Mass shape is irregular."]


def clip_configs(projection):
    overrides = [f"networks.text_encoder.config={TEXT}", "tokenizer.config.sequence_length=32",
                 *projection]
    return (jax_compose(CONFIGS, "train_binary_class_clf", overrides),
            compose(CONFIGS, "train_binary_class_clf", overrides))


@pytest.fixture(scope="module", params=["2xLinear256", "ProjectionHead", "moe512"])
def classifiers(request):
    projection = {
        "2xLinear256": ["projection=2xLinear256"],
        "ProjectionHead": ["projection.config.projection_name=ProjectionHead",
                           "projection.config.output_projection_dimension=32",
                           "+projection.config.hidden_dims=[48, 40]"],
        "moe512": ["projection=moe512", "projection.config.output_projection_dimension=32",
                   "projection.config.n_experts=4"],
    }[request.param]
    jcfg, cfg = clip_configs(projection)
    jtok = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name, sequence_length=32)
    jmodel = JaxMMGCLIP(jcfg, seed=3, vocab_size=jtok.vocab_size)
    tok = Tokenizer.from_pretrained(cfg.tokenizer.config.tokenizer_name, sequence_length=32)
    model = MMGCLIP(cfg, seed=3, vocab_size=tok.vocab_size)
    load_flax_tree(model.text_module, host(jmodel.text_variables)["params"])
    load_clip_params(model, host(jmodel.trainable_params), head_state=host(jmodel._head_state))
    model.eval()
    return (JaxPromptClassifier(jmodel, jtok), PromptClassifier(model, tok), jmodel, model)


def test_prompt_classifier_matches_jax(classifiers):
    jclf, clf, _jmodel, _model = classifiers
    x = features((5, 768), 6)
    ref, out = jclf(jnp.asarray(x), PROMPTS), clf(x, PROMPTS)
    np.testing.assert_allclose(out["classes_similarities"].numpy(),
                               np.asarray(ref["classes_similarities"]), rtol=TOL, atol=TOL)
    assert out["similarities_argmax_per_image"] == ref["similarities_argmax_per_image"]
    # quirk Q10: the single argmax is the first image's
    assert out["similarities_argmax"] == ref["similarities_argmax"] == \
        out["similarities_argmax_per_image"][0]
    one = clf(x[2], PROMPTS)  # a 1-d vector is one image
    assert one["similarities_argmax_per_image"] == [out["similarities_argmax_per_image"][2]]


def test_prompt_cache_is_dropped_when_the_params_change(classifiers):
    jclf, clf, jmodel, model = classifiers
    first = clf.encode_prompts(PROMPTS)
    assert clf.encode_prompts(PROMPTS) is first  # cached
    tree = host(jmodel.trainable_params)
    swapped = jax.tree_util.tree_map(lambda v: v * np.float32(1.5), tree)
    jclf.params = jax.tree_util.tree_map(jnp.asarray, swapped)
    clf.params = swapped
    try:
        after = clf.encode_prompts(PROMPTS)
        assert after is not first and not torch.allclose(after, first)
        np.testing.assert_allclose(after.numpy(), np.asarray(jclf.encode_prompts(PROMPTS)),
                                   rtol=TOL, atol=TOL)
        # an in-place update (a training step) drops it too
        with torch.no_grad():
            model.text_projection.parameters().__next__().mul_(2.0)
        assert clf.encode_prompts(PROMPTS) is not after
    finally:
        jclf.params = jax.tree_util.tree_map(jnp.asarray, tree)
        clf.params = tree
    np.testing.assert_allclose(clf.encode_prompts(PROMPTS).numpy(), first.numpy(), rtol=0, atol=0)
