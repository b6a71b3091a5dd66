"""The ResNet-50 family's modules in the port against the JAX package.

* ``ResNet50Encoder`` at micro width on flax's init carried across by name,
  with its running statistics moved away from 0 / 1, matches
  ``mmgclip_tpu.models.resnet`` within 1e-5 on even and odd feature widths;
  ``remat`` changes no gradient; at full width the parameter names and
  counts are flax's (23,508,032, of which ``layer4`` holds 14,964,736);
* ``MMGCLIP`` with ``networks=clip_resnet50_bert`` (micro tower): the
  trainable names are JAX's flattened ``trainable_params``, the freeze mask
  is ``resnet_finetune_mask``'s, ``count_parameters`` is equal, only
  ``layer4`` of the tower has ``requires_grad``; the forward logits match
  JAX's within 1e-5, and the weight round trip is bit-exact;
* the masked optimizer chain's checkpoint layout both ways: JAX restores the
  port's ``opt_state`` through its own template (byte-equal to what flax
  writes for the restored state) and the port resumes the JAX package's,
  the next steps then equal in both.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu.models.resnet import ResNet50Encoder as JaxResNet
from mmgclip_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from mmgclip_tpu.training import optim as jax_optim
from mmgclip_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from mmgclip_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from mmgclip_tpu_torch.config import compose
from mmgclip_tpu_torch.models.clip import MMGCLIP
from mmgclip_tpu_torch.models.resnet import ResNet50Encoder, ResNetConfig
from mmgclip_tpu_torch.training import optim
from mmgclip_tpu_torch.training.checkpoint import (adamw_state_from_optax, load_checkpoint,
                                                   save_checkpoint)
from mmgclip_tpu_torch.utils.flax_msgpack import from_bytes
from mmgclip_tpu_torch.weights import (clip_params_tree, flatten_tree, load_clip_params,
                                       load_flax_tree, load_head_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL = 1e-5
RESNET = ["networks=clip_resnet50_bert", "networks.image_encoder.config={micro: true}",
          "networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, "
          "num_attention_heads: 2, intermediate_size: 64, max_position_embeddings: 64}"]


def perturbed_stats(batch_stats, seed=0):
    """Running means in [-0.3, 0.3], variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        low, high = (0.5, 1.5) if str(path[-1].key) == "var" else (-0.3, 0.3)
        return rng.uniform(low, high, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(batch_stats))


@pytest.fixture(scope="module")
def micro():
    module = JaxResNet(JaxResNetConfig.micro())
    variables = jax.device_get(jax.jit(module.init)(jax.random.key(1), jnp.zeros((1, 768))))
    variables = {"params": variables["params"], "batch_stats": perturbed_stats(variables["batch_stats"])}
    tower = ResNet50Encoder(ResNetConfig.micro())
    load_flax_tree(tower, variables["params"])
    load_head_state(tower, {"batch_stats": variables["batch_stats"]})
    return module, variables, tower


@pytest.mark.parametrize("width", [768, 37])
def test_encoder_matches_flax(micro, width):
    module, variables, tower = micro
    x = np.random.default_rng(width).standard_normal((3, width)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the pseudo-image path and an explicit NCHW image agree
    image = torch.from_numpy(x)[:, None, None, :].repeat(1, 3, 1, 1)
    with torch.no_grad():
        np.testing.assert_array_equal(tower(image).numpy(), got)


def test_batch_norm_stays_frozen_in_train_mode(micro):
    _module, _variables, tower = micro
    before = {k: v.clone() for k, v in tower.named_buffers()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    with torch.no_grad():
        eval_out = tower.eval()(x)
        train_out = tower.train()(x)
    tower.eval()
    assert torch.equal(eval_out, train_out)
    assert all(torch.equal(before[k], v) for k, v in tower.named_buffers())


def test_remat_changes_no_gradient(micro):
    _module, variables, _tower = micro
    grads = []
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 40)).astype(np.float32))
    for remat in (True, False):
        tower = ResNet50Encoder(ResNetConfig(stage_sizes=(1, 1, 1, 1), width=8, remat=remat))
        load_flax_tree(tower, variables["params"])
        tower(x).square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in tower.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for key in grads[0]:
        torch.testing.assert_close(grads[0][key], grads[1][key], rtol=0, atol=0)


def test_full_width_names_and_counts():
    shapes = jax.eval_shape(JaxResNet(JaxResNetConfig.resnet50()).init, jax.random.key(0),
                            jnp.zeros((1, 2048)))
    theirs = {".".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    tower = ResNet50Encoder(ResNetConfig.resnet50())
    ours = {name: tuple(p.shape) for name, p in tower.named_parameters()}
    assert ours == theirs
    assert sum(int(np.prod(s)) for s in ours.values()) == 23_508_032
    assert sum(int(np.prod(s)) for k, s in ours.items() if k.startswith("layer4")) == 14_964_736
    assert tower.output_dimension == 2048


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("resnet_model"))
    jmodel = JaxMMGCLIP(jax_compose(CONFIGS, "train_binary_class_clf", RESNET, run_dir=run_dir),
                        seed=0, vocab_size=300)
    model = MMGCLIP(compose(CONFIGS, "train_binary_class_clf", RESNET, run_dir=run_dir),
                    seed=0, vocab_size=300)
    image_state = {"batch_stats": perturbed_stats(jmodel.image_variables["batch_stats"], seed=1)}
    jmodel.image_variables = {**jmodel.image_variables, **image_state}
    load_flax_tree(model.text_module, jax.device_get(jmodel.text_variables)["params"])
    load_clip_params(model, jax.device_get(jmodel.trainable_params), image_state=image_state)
    return jmodel, model


def test_trainable_names_mask_and_count(models):
    jmodel, model = models
    params = model.trainable_parameters()
    theirs = flatten_tree(jax.device_get(jmodel.trainable_params))
    assert sorted(params) == sorted(theirs)
    jmask = jax_optim.resnet_finetune_mask(jmodel.trainable_params)
    want = {".".join(str(k.key) for k in path): bool(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    mask = optim.resnet_finetune_mask(params)
    assert mask == want
    assert {name: p.requires_grad for name, p in params.items()} == mask
    assert any(mask.values()) and not all(mask.values())
    assert model.count_parameters() == jmodel.count_parameters()
    head_in = [p.shape[0] for k, p in params.items() if k.startswith("image_projection") and p.dim() == 2]
    assert head_in[0] == 256  # the tower's width * 32


def test_forward_logits_match_jax(models):
    jmodel, model = models
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((5, 1, 768, 1, 1)).astype(np.float32)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    want = jax.jit(lambda p, f, t: jmodel.forward(p, {"image_features": f}, text_features=t))(
        jmodel.trainable_params, jnp.asarray(feats), jnp.asarray(text))
    with torch.no_grad():
        got = model({"image_features": torch.from_numpy(feats)}, text_features=torch.from_numpy(text))
    for key in ("image_embeddings", "logits_per_image", "logits_per_text"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=TOL,
                                   err_msg=key)


def test_weight_round_trip_is_bit_exact(models):
    jmodel, model = models
    tree = jax.device_get(jmodel.trainable_params)
    back = flatten_tree(clip_params_tree(model))
    flat = flatten_tree(tree)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype and np.array_equal(back[key], value), key
    stats = flatten_tree(jmodel.image_variables["batch_stats"])
    buffers = {k: v.numpy() for k, v in model.image_module.named_buffers()}
    assert set(buffers) == set(stats)
    for key, value in stats.items():
        np.testing.assert_array_equal(buffers[key], value)
    with pytest.raises(KeyError):
        load_clip_params(model, {k: v for k, v in tree.items() if k != "image_encoder"})


# ----------------------------------------------------------------------
# the masked chain's optimizer state across checkpoints

def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def chain(models):
    """Two masked AdamW steps on the same grads in both packages."""
    jmodel, model = models
    init = flatten_tree(jax.device_get(jmodel.trainable_params))
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = optim.create_optimizer(params, 1e-2, 1e-2, freeze_mask=optim.resnet_finetune_mask(params))
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(init))
    tx = jax_optim.create_optimizer(1e-2, 1e-2, freeze_mask=jax_optim.resnet_finetune_mask(jparams))
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    for step in range(2):
        grads = _grads(init, step)
        for k, p in params.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, _nest(grads)), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return {"params": params, "opt": opt, "jparams": jparams, "tx": tx, "update": update, "state": state,
            "mask": optim.resnet_finetune_mask(params), "init": init}


def test_port_writes_the_masked_chain_jax_restores_it(chain, tmp_path):
    path = str(tmp_path / "port.msgpack")
    host = {k: v.detach().numpy() for k, v in chain["params"].items()}
    save_checkpoint(path, _nest(host), chain["opt"].state_dict(), epoch=1, rng_key=[0, 7])
    template = chain["tx"].init(chain["jparams"])
    restored = jax_load_checkpoint(path, chain["jparams"], template)
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    assert serialization.to_bytes(jax.device_get(restored["opt_state"])) == raw["opt_state"]
    decoded = from_bytes(raw["opt_state"])
    assert set(decoded) == {"0", "1"} and decoded["1"] == {"inner_state": {}}
    inner = restored["opt_state"][0].inner_state
    assert int(inner.count) == int(inner.inner_state[0].count) == 2
    for slot in ("mu", "nu"):
        moments = jax.device_get(getattr(inner.inner_state[0], slot))
        flat = {".".join(str(k.key) for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(
                    moments, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]}
        for name, trainable in chain["mask"].items():
            if trainable:
                np.testing.assert_array_equal(flat[name], getattr(chain["opt"], slot)[name].numpy())
            else:
                assert isinstance(flat[name], optax.MaskedNode), name
    # the restored state steps on as the JAX package's own state does
    grads = jax.tree_util.tree_map(jnp.asarray, _nest(_grads(chain["init"], 5)))
    ours, _ = chain["update"](grads, restored["opt_state"], chain["jparams"])
    theirs, _ = chain["update"](grads, chain["state"], chain["jparams"])
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7, rtol=1e-6)


def test_port_resumes_the_jax_masked_chain(chain, tmp_path):
    path = str(tmp_path / "jax.msgpack")
    jax_save_checkpoint(path, chain["jparams"], chain["state"], epoch=1, rng_key=jax.random.key(0))
    loaded = load_checkpoint(path)
    state = loaded["opt_state"]
    assert int(state["count"]) == 2
    for slot in ("mu", "nu"):
        assert set(state[slot]) == set(chain["mask"])
        for name, trainable in chain["mask"].items():
            if trainable:  # the JAX moments against the port's, stepped on the same grads
                np.testing.assert_allclose(state[slot][name], getattr(chain["opt"], slot)[name].numpy(),
                                           atol=1e-6, err_msg=name)
            else:
                assert state[slot][name] == {}, name
    params = {k: torch.nn.Parameter(torch.tensor(v))
              for k, v in flatten_tree(loaded["params"]).items()}
    opt = optim.create_optimizer(params, 0.0, 0.0, freeze_mask=optim.resnet_finetune_mask(params))
    opt.load_state_dict(state)
    grads = _grads(chain["init"], 5)
    for k, p in params.items():
        p.grad = torch.tensor(grads[k])
    opt.step()
    updates, _ = chain["update"](jax.tree_util.tree_map(jnp.asarray, _nest(grads)),
                                 chain["state"], chain["jparams"])
    want = flatten_tree(jax.device_get(optax.apply_updates(chain["jparams"], updates)))
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, err_msg=name)
        if not chain["mask"][name]:
            np.testing.assert_array_equal(p.detach().numpy(), chain["init"][name])


def test_unknown_optimizer_layout_raises_without_naming_the_tower():
    with pytest.raises(NotImplementedError) as info:
        adamw_state_from_optax({"0": {"mu": {}}, "1": {}})
    assert "ResNet" not in str(info.value) and "refuse" not in str(info.value)
