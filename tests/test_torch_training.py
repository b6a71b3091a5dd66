"""The port's training modules against the JAX package's, at small sizes.

Inputs are made with numpy from fixed seeds and fed to both.  Tolerances:
losses and their gradients 1e-6 (fp32, the same formulas); the training
forward's embeddings and logits 1e-5 (logits scale by 14.3); AdamW against
optax over 5 steps with a learning-rate change 1e-6; schedules, splits,
epoch orders, loader and sampler orders, dataset rows, supervision text and
token ids exactly; metrics and the bootstrap CI 1e-12 (the same numpy code);
the msgpack writer byte for byte against flax.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from fixtures import build_image_label_tree, build_study_report_fixture
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.data import datasets as jax_datasets
from mmgclip_tpu.data import loader as jax_loader
from mmgclip_tpu.data import sampler as jax_sampler
from mmgclip_tpu.data import split as jax_split
from mmgclip_tpu.evaluation import metrics as jax_metrics
from mmgclip_tpu.losses import losses as jax_losses
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu.training import experiment as jax_experiment
from mmgclip_tpu.training import optim as jax_optim
from mmgclip_tpu.utils.table import Table as JaxTable
from mmgclip_tpu_torch.config import compose
from mmgclip_tpu_torch.config.yaml_lite import dump, load
from mmgclip_tpu_torch.data import datasets, loader, sampler, split
from mmgclip_tpu_torch.evaluation import metrics
from mmgclip_tpu_torch.losses import losses
from mmgclip_tpu_torch.models.clip import MMGCLIP
from mmgclip_tpu_torch.training import experiment, optim
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.utils import prng
from mmgclip_tpu_torch.utils.flax_msgpack import from_bytes, to_bytes
from mmgclip_tpu_torch.utils.table import Table
from mmgclip_tpu_torch.weights import clip_params_tree, load_clip_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
LOSS_TOL = 1e-6
FORWARD_TOL = 1e-5  # embeddings and logits (logit scale 14.3 times unit dot products)
OPT_TOL = 1e-6
METRIC_TOL = 1e-12


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def torch_grads(fn, *arrays):
    tensors = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*tensors)
    out.backward()
    return out.item(), [np.zeros_like(a) if t.grad is None else t.grad.numpy()
                        for a, t in zip(arrays, tensors)]


def jax_grads(fn, *arrays):
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return float(value), [np.asarray(g) for g in grads]


def duplicated_texts(rng, n=12, d=16):
    """Text rows with exact and near duplicates, so the greedy clustering
    merges some rows and not others."""
    txt = unit(rng, n, d)
    txt[3] = txt[0]
    txt[7] = txt[0] + 0.05 * rng.standard_normal(d).astype(np.float32)
    txt[9] = txt[5]
    return txt / np.linalg.norm(txt, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["CLIPLoss", "MMGCLIPLoss", "AveragedMedicalCLIPLoss"])
def test_losses_and_gradients_match_jax(name):
    rng = np.random.default_rng(0)
    n, d, scale = 12, 16, np.float32(1 / 0.07)
    img, txt, txt2 = unit(rng, n, d), duplicated_texts(rng, n, d), unit(rng, n, d)

    def make(mod, xp):
        def fn(i, t, t2):
            out = {"image_embeddings": i, "text_embeddings": t, "text_embeddings2": t2,
                   "logit_scale": scale, "logits_per_image": scale * i @ t.T,
                   "logits_per_text": scale * t @ i.T}
            return mod.create_loss(name)(**out)[0]
        return fn

    ours, our_grads = torch_grads(make(losses, torch), img, txt, txt2)
    theirs, their_grads = jax_grads(make(jax_losses, jnp), img, txt, txt2)
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_TOL)
    for a, b in zip(our_grads, their_grads):
        np.testing.assert_allclose(a, b, atol=LOSS_TOL)


@pytest.mark.parametrize("threshold", [0.65, 0.99, -1.0])
def test_similarity_labels_match_jax_with_duplicate_texts(threshold):
    rng = np.random.default_rng(1)
    txt = duplicated_texts(rng)
    sims = txt @ txt.T
    ours = losses.assign_similarity_labels(torch.tensor(sims), threshold).numpy()
    theirs = np.asarray(jax_losses.assign_similarity_labels(jnp.asarray(sims), threshold))
    np.testing.assert_array_equal(ours, theirs)
    logits = rng.standard_normal((12, 12)).astype(np.float32)
    np.testing.assert_allclose(
        losses.average_logits_by_label(torch.tensor(logits), torch.tensor(ours)).numpy(),
        np.asarray(jax_losses.average_logits_by_label(jnp.asarray(logits), jnp.asarray(theirs))),
        atol=LOSS_TOL)


@pytest.mark.parametrize("freeze", [False, True])
def test_adamw_with_a_learning_rate_change_matches_optax(freeze):
    rng = np.random.default_rng(2)
    shapes = {"image_encoder.layer3.kernel": (4, 3), "image_encoder.layer4.kernel": (3, 5),
              "text_projection.layer.kernel": (6, 4), "logit_scale": ()}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]

    def nest(flat):
        tree = {}
        for key, value in flat.items():
            *parents, leaf = key.split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = value
        return tree

    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    mask = optim.resnet_finetune_mask(params) if freeze else None
    opt = optim.create_optimizer(params, 5e-3, 1e-2, freeze_mask=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, nest(init))
    jmask = jax_optim.resnet_finetune_mask(jparams) if freeze else None
    if freeze:
        assert nest(mask) == jmask
    tx = jax_optim.create_optimizer(5e-3, 1e-2, freeze_mask=jmask)
    state = tx.init(jparams)
    for step, g in enumerate(grads):
        if step == 2:
            optim.set_learning_rate(opt, 1e-3)
            state = jax_optim.set_learning_rate(state, 1e-3)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, nest(g)), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    flat_jax = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for key, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), flat_jax[key], atol=OPT_TOL, err_msg=key)
    if freeze:
        np.testing.assert_array_equal(params["image_encoder.layer3.kernel"].detach().numpy(),
                                      init["image_encoder.layer3.kernel"])


def test_adamw_state_round_trips():
    params = {"w": torch.nn.Parameter(torch.ones(3))}
    opt = optim.AdamW(params, 1e-2, 1e-4)
    params["w"].grad = torch.tensor([1.0, -2.0, 3.0])
    opt.step()
    state = from_bytes(to_bytes(opt.state_dict()))
    other = optim.AdamW({"w": torch.nn.Parameter(torch.ones(3))}, 0.0, 0.0)
    other.load_state_dict(state)
    assert int(other.count) == 1 and float(other.hyperparams["learning_rate"]) == np.float32(1e-2)
    torch.testing.assert_close(other.mu["w"], opt.mu["w"], rtol=0, atol=0)
    torch.testing.assert_close(other.nu["w"], opt.nu["w"], rtol=0, atol=0)


@pytest.mark.parametrize("scheduler", ["warmup0.1", "warmup1_epo15", "warmup0.1_epo300",
                                       "reduceLRonplateau._epo30"])
def test_schedules_match_jax_exactly(scheduler):
    cfg = compose(CONFIGS, "train_binary_class_clf", [f"scheduler={scheduler}"], run_dir="/tmp/x")
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", [f"scheduler={scheduler}"], run_dir="/tmp/x")
    ours, theirs = optim.create_scheduler(cfg), jax_optim.create_scheduler(jcfg)
    assert type(ours).__name__ == type(theirs).__name__
    if hasattr(theirs, "lr_at"):
        epochs = int(cfg.scheduler.config.epochs)
        assert [ours.lr_at(e) for e in range(epochs + 2)] == [theirs.lr_at(e) for e in range(epochs + 2)]
    else:
        metrics_seq = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.98, 0.99, 0.99, 0.8, 0.81] * 3
        assert [ours.step(m) for m in metrics_seq] == [theirs.step(m) for m in metrics_seq]


@pytest.mark.parametrize("n,ratio,seed", [(10, 0.7, 42), (97, 0.5, 0), (1, 0.7, 3), (512, 0.7, 42)])
def test_seeded_split_is_bit_equal(n, ratio, seed):
    for a, b in zip(split.seeded_split(n, ratio, seed), jax_split.seeded_split(n, ratio, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,bs,drop_last", [(358, 32, True), (358, 32, False), (5, 8, False),
                                            (64, 8, True), (17, 4, False)])
def test_epoch_order_is_bit_equal(n, bs, drop_last):
    for epoch in range(3):
        ours = experiment._epoch_order(n, bs, drop_last, np.random.default_rng((42, epoch)))
        theirs = jax_experiment._epoch_order(n, bs, drop_last, np.random.default_rng((42, epoch)))
        np.testing.assert_array_equal(ours, theirs)


class _Rows:
    """A dataset stand-in: item i carries its index and a class string."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": i, "image_description": ["benign", "malignant", "mass"][i % 3 if i % 5 else 0]}

    @staticmethod
    def collate_fn(items):
        return [item["index"] for item in items]


@pytest.mark.parametrize("shuffle,drop_last,use_sampler", [(True, True, False), (True, False, False),
                                                           (False, True, False), (True, False, True)])
def test_loader_batch_order_is_bit_equal(shuffle, drop_last, use_sampler):
    ours_loader = loader.DataLoaders(_cfg(), split.Subset(_Rows(50), np.arange(3, 50))).get_dataloader(
        shuffle=shuffle, batch_size=8, drop_last=drop_last, use_sampler=use_sampler)
    theirs_loader = jax_loader.DataLoaders(_cfg(), jax_split.Subset(_Rows(50), np.arange(3, 50))).get_dataloader(
        shuffle=shuffle, batch_size=8, drop_last=drop_last, use_sampler=use_sampler)
    assert len(ours_loader) == len(theirs_loader)
    for _epoch in range(3):
        assert list(ours_loader) == list(theirs_loader)


def _cfg():
    return compose(CONFIGS, "train_binary_class_clf", ["dataset/percentage=p20"], run_dir="/tmp/x")


def test_dataloader_percentage_and_sampler_match_jax():
    cfg = _cfg()
    ours = loader.dataloader_percentage(loader.DataLoader(_Rows(40), batch_size=4), cfg)
    theirs = jax_loader.dataloader_percentage(jax_loader.DataLoader(_Rows(40), batch_size=4), cfg)
    assert list(ours) == list(theirs)
    s_ours = sampler.ImbalancedDatasetSampler(_Rows(31), seed=5)
    s_theirs = jax_sampler.ImbalancedDatasetSampler(_Rows(31), seed=5)
    assert len(s_ours) == len(s_theirs) and list(s_ours) == list(s_theirs) and list(s_ours) == list(s_theirs)


@pytest.fixture(scope="module")
def label_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("labels")
    return str(root), build_image_label_tree(str(root), n_benign=7, n_malignant=6)


DATASET_MODES = {
    "binary": [],
    "mass_shape": ["dataset=multi-label"],
    "gtr_report": ["dataset.config.generate_label_prompt_report=true"],
}


@pytest.mark.parametrize("mode", sorted(DATASET_MODES))
def test_image_label_dataset_is_bit_equal(label_tree, mode):
    root, (base, annotated, lists, features) = label_tree
    overrides = [*DATASET_MODES[mode], f"dataset.config.base_dataset_path={base}",
                 f"dataset.config.annotated_dataset_path={annotated}",
                 f"dataset.config.lists_dataset_path={lists}", f"base.features_export_dir={features}"]
    ours = datasets.get_dataset("ImageLabelDataset")(
        config=compose(CONFIGS, "train_binary_class_clf", overrides, run_dir=f"{root}/ours_{mode}"))
    theirs = jax_datasets.get_dataset("ImageLabelDataset")(
        config=jax_compose(CONFIGS, "train_binary_class_clf", overrides, run_dir=f"{root}/jax_{mode}"))
    assert len(ours) == len(theirs) > 0
    for key in theirs._tokens:
        np.testing.assert_array_equal(ours._tokens[key], theirs._tokens[key])
    np.testing.assert_array_equal(ours._features, theirs._features)
    assert ours._prompt_labels == theirs._prompt_labels
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert (a["index"], a["image_description"], a["image_id"]) == (b["index"], b["image_description"],
                                                                       b["image_id"])
        np.testing.assert_array_equal(a["image_label"], b["image_label"])
    batch_ours = ours.collate_fn([ours[i] for i in (2, 0, 5)])
    batch_theirs = theirs.collate_fn([theirs[i] for i in (2, 0, 5)])
    for key in ("indices", "image_features", "image_label"):
        np.testing.assert_array_equal(batch_ours[key], batch_theirs[key])
    assert batch_ours["image_description"] == batch_theirs["image_description"]
    with open(f"{root}/ours_{mode}/image_description.txt") as fa, \
            open(f"{root}/jax_{mode}/image_description.txt") as fb:
        assert fa.read() == fb.read()
    for left, right in zip(ours.random_split(ours, "train"), theirs.random_split(theirs, "train")):
        np.testing.assert_array_equal(left.indices, right.indices)


def test_study_report_dataset_waits_for_its_slice(tmp_path):
    """Its slice has landed: the registered ``StudyReportDataset`` builds the
    JAX package's supervision (``tests/test_torch_exam_dataset.py`` holds it
    in every GTR mode)."""
    reports_csv, gtr_csv, _features = build_study_report_fixture(str(tmp_path), n_studies=6)
    overrides = [f"dataset.config.final_reports_dataset_path={reports_csv}",
                 f"dataset.config.gt_path={gtr_csv}"]
    ours = datasets.get_dataset("StudyReportDataset")(
        config=compose(CONFIGS, "train_exam_reports_clf", overrides, run_dir=str(tmp_path / "ours")))
    theirs = jax_datasets.get_dataset("StudyReportDataset")(
        config=jax_compose(CONFIGS, "train_exam_reports_clf", overrides, run_dir=str(tmp_path / "jax")))
    assert [row["image_description"] for row in ours.rows] == \
        theirs.final_reports_dataset["image_description"].tolist()


def test_metrics_and_bootstrap_ci_match_jax():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, size=60)
    score = rng.standard_normal(60) + y
    score[::7] = score[0]  # ties
    for name in ("roc_curve",):
        for a, b in zip(getattr(metrics, name)(y, score), getattr(jax_metrics, name)(y, score)):
            np.testing.assert_allclose(a, b, atol=METRIC_TOL)
    assert abs(metrics.roc_auc_score(y, score) - jax_metrics.roc_auc_score(y, score)) <= METRIC_TOL
    ours, theirs = metrics.bootstrap_auc_ci(y, score, seed=42), jax_metrics.bootstrap_auc_ci(y, score, seed=42)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert abs(ours[key] - theirs[key]) <= METRIC_TOL
    pred = rng.integers(0, 3, size=60)
    np.testing.assert_array_equal(metrics.confusion_matrix(y, pred, labels=range(3)),
                                  jax_metrics.confusion_matrix(y, pred, labels=range(3)))
    assert metrics.f1_score(y, pred % 2) == jax_metrics.f1_score(y, pred % 2)
    curves = [metrics.roc_curve(y, score)[:2], metrics.roc_curve(1 - y, -score)[:2]]
    for a, b in zip(metrics.mean_roc_curve(curves), jax_metrics.mean_roc_curve(curves)):
        np.testing.assert_allclose(a, b, atol=METRIC_TOL)
    np.testing.assert_allclose(metrics.softmax(np.outer(score, [1, 2])),
                               jax_metrics.softmax(np.outer(score, [1, 2])), atol=METRIC_TOL)
    table, jtable = Table(["a", "b"]), JaxTable(["a", "b"])
    for t in (table, jtable):
        t.add_row(["x", 0.123456789])
        t.add_row(["longer", float("nan")])
    assert str(table) == str(jtable)


def test_msgpack_writer_is_flax_bytes():
    rng = np.random.default_rng(4)
    tree = {"image_projection": {"layers_0": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                                              "bias": np.zeros(5, np.float32)}},
            "text_projection": {"layer": {"kernel": rng.standard_normal((300, 20)).astype(np.float32)}},
            "logit_scale": np.asarray(2.6592600345611572, np.float32)}
    ours = to_bytes(tree)
    assert ours == serialization.to_bytes(jax.tree_util.tree_map(jnp.asarray, tree))
    back = serialization.from_bytes(jax.tree_util.tree_map(np.zeros_like, tree), ours)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_yaml_dump_reads_back_in_both_readers():
    import yaml

    data = {"a": {"b": [1, 2.5, "x y"], "c": "5e-5", "d": None, "e": True, "f": [],
                  "g": {}, "h": [{"k": 1}, [1, 2]], "quoted: key": "line\nbreak \"q\" é",
                  "n": float("inf"), "m": 1e-20, "yes": "no"}}
    from mmgclip_tpu.config.compose import _yaml_load as jax_yaml_load

    text = dump(data)
    assert load(text) == data
    assert yaml.safe_load(text) == data  # YAML 1.1 reads the floats too
    assert jax_yaml_load(text) == data


def _tiny_model_config(loss, projection="2xLinear256", dropout=0.0):
    overrides = ["networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, "
                 "num_attention_heads: 2, intermediate_size: 64, vocab_size: 128}",
                 f"networks.dropout.config.dropout={dropout}", f"projection={projection}",
                 f"loss={loss}"]
    return (compose(CONFIGS, "train_binary_class_clf", overrides, run_dir="/tmp/x"),
            jax_compose(CONFIGS, "train_binary_class_clf", overrides, run_dir="/tmp/x"))


@pytest.mark.parametrize("loss", ["clip", "mmgclip"])
def test_training_forward_matches_jax(loss):
    _forward_against_jax(loss, dropout=0.0)


@pytest.mark.parametrize("loss", ["clip", "mmgclip"])
def test_training_forward_with_dropout_matches_jax(loss):
    """Dropout 0.5 in all three heads: the step key splits three ways as in
    the JAX model, so the embeddings (masks included) match."""
    _forward_against_jax(loss, dropout=0.5)


def _forward_against_jax(loss, dropout):
    cfg, jcfg = _tiny_model_config(loss, dropout=dropout)
    jmodel = JaxMMGCLIP(jcfg, seed=3)
    model = MMGCLIP(cfg, seed=3)
    load_clip_params(model, jax.device_get(jmodel.trainable_params))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((6, 768)).astype(np.float32)
    text, text2 = (rng.standard_normal((6, 32)).astype(np.float32) for _ in range(2))
    ours = model({"image_features": torch.tensor(feats)}, train=True, key=prng.key(0),
                 text_features=torch.tensor(text), text_features2=torch.tensor(text2))
    theirs = jmodel.forward(jmodel.trainable_params, {"image_features": jnp.asarray(feats)}, train=True,
                            rng=jax.random.key(0), text_features=jnp.asarray(text),
                            text_features2=jnp.asarray(text2))
    assert set(ours) == set(theirs) and ("text_embeddings2" in ours) == (loss == "mmgclip")
    for key in theirs:
        np.testing.assert_allclose(ours[key].detach().numpy(), np.asarray(theirs[key]),
                                   atol=FORWARD_TOL, err_msg=key)
    tree = clip_params_tree(model)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.device_get(jmodel.trainable_params))
    assert sorted(model.trainable_parameters()) == sorted(
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jmodel.trainable_params)[0])
    assert not any(p.requires_grad for p in model.text_module.parameters())


# every head kind with a Dropout: (JAX class, port class, constructor kwargs)
DROPOUT_HEADS = {
    "MultiLinearHead": ("MultiLinearHead", {"projection_dim": (40, 24, 16), "dropout": 0.5}),
    "ProjectionHead": ("ProjectionHead", {"projection_dim": 16, "dropout": 0.2,
                                          "hidden_dims": (40, 24)}),
    "MLPProjectionHead": ("MLPProjectionHead", {"projection_dim": 24, "dropout": 0.5}),
    "MoEProjectionHead": ("MoEProjectionHead", {"projection_dim": 16, "dropout": 0.2,
                                                "n_experts": 4, "capacity_factor": 2.0}),
}


@pytest.mark.parametrize("name", sorted(DROPOUT_HEADS))
def test_train_mode_dropout_masks_equal_flax(name):
    """Each Dropout site of a head, on flax's own input to it, draws flax's
    mask and output bit for bit under the head's key (``make_rng``'s fold-in
    of ``Dropout_<i>``); the whole head's train-mode output matches
    ``module.apply(..., rngs={"dropout": key})`` on carried-over params
    within the forward tolerance, and two seeds draw other masks."""
    import flax.linen as nn

    from mmgclip_tpu.models import projections as jax_projections
    from mmgclip_tpu_torch.models import projections as port_projections
    from mmgclip_tpu_torch.models.projections import dropout
    from mmgclip_tpu_torch.utils import prng
    from mmgclip_tpu_torch.weights import load_flax_tree, load_head_state

    cls_name, kwargs = DROPOUT_HEADS[name]
    x = np.random.default_rng(11).standard_normal((24, 48)).astype(np.float32)
    jhead = getattr(jax_projections, cls_name)(embedding_dim=48, **kwargs)
    variables = jax.device_get(jhead.init(jax.random.key(2), jnp.asarray(x)))
    port_kwargs = {k: v for k, v in kwargs.items() if k not in ("projection_dim", "dropout")}
    head = getattr(port_projections, cls_name)(48, kwargs["projection_dim"], kwargs["dropout"],
                                                **port_kwargs)
    load_flax_tree(head, variables["params"])
    load_head_state(head, {k: v for k, v in variables.items() if k != "params"})

    for seed in (0, 7):
        sites = []

        def record(next_fun, args, kwargs_, context):
            out = next_fun(*args, **kwargs_)
            if isinstance(context.module, nn.Dropout):
                sites.append((context.module.name, np.asarray(args[0]), np.asarray(out)))
            return out

        mutable = [k for k in variables if k != "params"] or False
        with nn.intercept_methods(record):
            ref = jhead.apply(variables, jnp.asarray(x), deterministic=False,
                              rngs={"dropout": jax.random.key(seed)}, mutable=mutable)
        ref = np.asarray(ref[0] if mutable else ref)
        assert [site for site, _i, _o in sites] == [f"Dropout_{i}" for i in range(len(head._folds))]
        for i, (site, inp, out) in enumerate(sites):
            ours = dropout(torch.from_numpy(inp), kwargs["dropout"], True, prng.key(seed),
                           head._folds[i]).numpy()
            np.testing.assert_array_equal(ours, out, err_msg=f"{name} {site} seed {seed}")
            assert 0 < (out == 0).mean() < 1
        with torch.no_grad():
            got = head(torch.from_numpy(x), train=True, key=prng.key(seed)).numpy()
        np.testing.assert_allclose(got, ref, atol=FORWARD_TOL, rtol=FORWARD_TOL)
        if seed == 0:
            first = got
    assert not np.array_equal(first, got)


@pytest.mark.parametrize("override", ["parallel=tp2", "parallel=pp2",
                                      "optimizer.config.zero_sharding=true"])
def test_multi_device_layouts_raise(override):
    """In one process the layouts follow the JAX trainer's rule over one
    device: a model or pipe axis of 2 cannot be hosted (its error), and
    ZeRO-1 over a data axis of 1 leaves the moments whole.  The layouts
    themselves run across processes (tests/test_torch_train_dp.py)."""
    cfg = compose(CONFIGS, "train_binary_class_clf", [override], run_dir="/tmp/x")
    if override.startswith("parallel="):
        with pytest.raises(ValueError, match="1 devices cannot host a model/pipe axis of size 2"):
            experiment.ClassifierExperiment(config=cfg, device="cpu")
        return
    exp = experiment.ClassifierExperiment(config=cfg, device="cpu")
    assert type(exp.optimizer).__name__ == "AdamW" and exp.mesh.shape == {"data": 1, "model": 1}


def test_scalar_writer_and_trace(tmp_path):
    from mmgclip_tpu_torch.utils.profiling import maybe_trace
    from mmgclip_tpu_torch.utils.tb import ScalarWriter, read_scalars

    writer = ScalarWriter(str(tmp_path / "runs"))
    writer.add_scalar("loss/train", 1.5, 1)
    writer.add_scalar("loss/train", 1.25, 2)
    writer.close()
    assert read_scalars(str(tmp_path / "runs")) == {"loss/train": [1.5, 1.25]}
    lines = [json.loads(line) for line in open(tmp_path / "runs" / "scalars.jsonl")]
    assert [line["step"] for line in lines] == [1, 2]
    with maybe_trace(True, str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path / "trace"))


def _tiny_run(label_tree, name, extra=()):
    from mmgclip_tpu_torch.train import run

    root, (base, annotated, lists, features) = label_tree
    run_dir = f"{root}/{name}"
    cfg = compose(CONFIGS, "train_binary_class_clf", [
        f"dataset.config.base_dataset_path={base}", f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}", f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        "networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 1, num_attention_heads: 2, "
        "intermediate_size: 64}", "projection=2xLinear256", "networks.dropout.config.dropout=0.2",
        "dataloader.train.batch_size=2", "dataloader.valid.batch_size=1", "dataloader.test.batch_size=1",
        "scheduler.config.epochs=3", *extra], run_dir=run_dir)
    return cfg, run(cfg, device="cpu")


def _live_params(experiment_):
    return {k: p.detach().clone() for k, p in experiment_.model.trainable_parameters().items()}


def test_resume_continues_a_run_exactly(label_tree):
    """Two epochs, then a resumed third from the checkpoint (AdamW moments
    and the dropout generator restored): the params equal a straight
    three-epoch run's bit for bit."""
    _cfg3, straight = _tiny_run(label_tree, "straight")
    cfg2, _two = _tiny_run(label_tree, "resumed", ["scheduler.config.epochs=2"])
    state = load_checkpoint(os.path.join(cfg2.checkpoints.checkpoints_export_dir, "model.msgpack"))
    assert state["epoch"] == 1, "the second epoch must be the best for this test to mean anything"
    _cfg, resumed = _tiny_run(label_tree, "resumed", ["base.resume=true"])
    for key, value in _live_params(straight).items():
        torch.testing.assert_close(_live_params(resumed)[key], value, rtol=0, atol=0, msg=key)


def test_per_batch_loop_matches_the_fused_epoch(label_tree):
    from mmgclip_tpu_torch.utils.tb import read_scalars

    cfg_f, fused = _tiny_run(label_tree, "fused", ["networks.dropout.config.dropout=0.0"])
    cfg_l, loop = _tiny_run(label_tree, "loop", ["networks.dropout.config.dropout=0.0",
                                                 "base.fused_epoch=false"])
    np.testing.assert_allclose(read_scalars(cfg_l.base.tensorboard_export_dir)["loss/train"],
                               read_scalars(cfg_f.base.tensorboard_export_dir)["loss/train"], rtol=1e-6)
    for key, value in _live_params(fused).items():
        torch.testing.assert_close(_live_params(loop)[key], value, rtol=1e-6, atol=1e-7, msg=key)
    cfg_s, _sampled = _tiny_run(label_tree, "sampler", ["dataloader.train.use_sampler=true"])
    assert np.isfinite(read_scalars(cfg_s.base.tensorboard_export_dir)["loss/train"]).all()
