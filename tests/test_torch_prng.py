"""The port's threefry (``mmgclip_tpu_torch/utils/prng.py``, the plain
version of ``ops/dropout.py``'s kernels) against ``jax.random`` and flax.

``split``, ``fold_in``, ``random_bits``, ``uniform`` and ``bernoulli`` must
be bit-equal to jax 0.9's over hypothesis-drawn seeds and shapes (empty, odd
sizes, up to ~1e5 elements); flax's static fold-in and ``nn.Dropout`` too.
The port assumes ``jax_threefry_partitionable`` (the counters are the linear
index, 32-bit bits the xor of the two hash words): a test pins it.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static
from hypothesis import given, settings
from hypothesis import strategies as st

from mmgclip_tpu_torch.ops import dropout as dropout_op
from mmgclip_tpu_torch.utils import prng

SEEDS = st.integers(min_value=0, max_value=2**31 - 1)
SHAPES = st.one_of(
    st.just((0,)), st.just((3, 0)),
    st.lists(st.integers(min_value=1, max_value=47), min_size=1, max_size=3).map(tuple),
    st.sampled_from([(1,), (7,), (1001,), (333, 301), (100_003,)]))


def key_data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_threefry_is_partitionable_and_flax_separator_is_off():
    assert jax.config.jax_threefry_partitionable is True
    assert flax.config.flax_fix_rng_separator is False


@settings(max_examples=30, deadline=None)
@given(seed=SEEDS, n=st.integers(min_value=1, max_value=9))
def test_key_and_split_equal_jax(seed, n):
    key = jax.random.key(seed)
    assert np.array_equal(prng.key(seed).numpy(), key_data(key))
    assert np.array_equal(prng.split(prng.key(seed), n).numpy(), key_data(jax.random.split(key, n)))


@settings(max_examples=30, deadline=None)
@given(seed=SEEDS, data=st.integers(min_value=0, max_value=2**32 - 1))
def test_fold_in_equals_jax(seed, data):
    want = key_data(jax.random.fold_in(jax.random.key(seed), np.uint32(data)))
    assert np.array_equal(prng.fold_in(prng.key(seed), data).numpy(), want)


@settings(max_examples=25, deadline=None)
@given(seed=SEEDS, shape=SHAPES)
def test_random_bits_and_uniform_equal_jax(seed, shape):
    key = jax.random.key(seed)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(prng.key(seed), shape).numpy(), bits)
    uniform = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    assert np.array_equal(prng.uniform(prng.key(seed), shape).numpy(), uniform)


@settings(max_examples=25, deadline=None)
@given(seed=SEEDS, shape=SHAPES, p=st.sampled_from([0.5, 0.8, 0.9, 1.0 - 0.1, 0.0, 1.0, 1e-3]))
def test_bernoulli_equals_jax(seed, shape, p):
    want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, shape))
    assert np.array_equal(prng.bernoulli(prng.key(seed), p, shape).numpy(), want)


@pytest.mark.parametrize("suffix", [(), (1,), ("Dropout_0", 1), ("Dropout_1", 2),
                                    ("image_projection", "Dropout_0", 300), ("é", 0)])
def test_static_fold_in_equals_flax(suffix):
    key = jax.random.key(5)
    want = key_data(_fold_in_static(key, suffix))
    assert np.array_equal(prng.fold_in_static(prng.key(5), suffix).numpy(), want)


@pytest.mark.parametrize("rate", [0.5, 0.2, 0.1])
@pytest.mark.parametrize("shape", [(64, 768), (5, 3, 7)])
def test_plain_dropout_equals_flax_dropout(rate, shape):
    """flax's ``nn.Dropout`` applied on its own folds in the suffix ``(1,)``;
    the kept values are ``x / keep`` by IEEE division (eager flax)."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(flax.linen.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.key(9)}))
    fold = prng.static_fold_constant((1,))
    got = dropout_op.dropout(torch.from_numpy(x), prng.key(9), fold, rate)
    assert np.array_equal(got.numpy(), want)
    out, mask = dropout_op.plain_dropout(torch.from_numpy(x), prng.key(9), fold, 1.0 - rate)
    assert np.array_equal(mask.numpy(), want != 0) and np.array_equal(out.numpy(), want)


def test_dropout_backward_is_the_vjp_of_flax_select():
    x = np.random.default_rng(4).standard_normal((33, 17)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((33, 17)).astype(np.float32)
    fold = prng.static_fold_constant((1,))

    def flax_dropout(v):
        return flax.linen.Dropout(0.2, deterministic=False).apply(
            {}, v, rngs={"dropout": jax.random.key(2)})

    _y, vjp = jax.vjp(flax_dropout, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    dropout_op.dropout(xt, prng.key(2), fold, 0.2).backward(torch.from_numpy(g))
    assert np.array_equal(xt.grad.numpy(), want)


def test_wrappers_run_the_plain_version_on_cpu_and_count_no_launch():
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    key = prng.key(1)
    assert torch.equal(dropout_op.split(key, 3), prng.split(key, 3))
    assert torch.equal(dropout_op.fold_in(key, 77), prng.fold_in(key, 77))
    dropout_op.dropout(torch.ones(4, 4), key, 3, 0.5)
    assert launch_counts()["threefry2x32"] == launch_counts()["dropout"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        dropout_op.launch_dropout(torch.ones(2), key, 0, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        dropout_op.launch_threefry2x32(key, 0, 2)
