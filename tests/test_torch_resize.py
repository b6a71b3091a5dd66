"""The port's resize chain (``ops/resize.py``) against the JAX package's.

The weight builders and the host block sum are copies and must be bit-equal;
the resamples at ``highest`` precision are fp32 products on both sides and
must agree within 1e-5 (relative to the 16-bit range); ``default`` precision
(bf16 operands, fp32 sums: the TPU's single pass) is held to the bound
``tests/test_resize.py::test_default_precision_truncation_bound`` sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.ops import resize as jax_resize
from mmgclip_tpu_torch.ops import resize

TOL = 1e-5


@pytest.mark.parametrize("n_in,n_out", [(64, 32), (57, 13), (100, 37), (8, 8), (13, 40)])
@pytest.mark.parametrize("method", ["area", "bilinear"])
def test_weights_bit_equal(n_in, n_out, method):
    np.testing.assert_array_equal(resize._resize_weights(n_in, n_out, method),
                                  jax_resize._resize_weights(n_in, n_out, method))
    for k in (2, 3, 4):
        np.testing.assert_array_equal(resize._block_sum_weights(n_in, n_out, k, method),
                                      jax_resize._block_sum_weights(n_in, n_out, k, method))


@pytest.mark.parametrize("dtype,k", [(np.uint8, 2), (np.uint8, 16), (np.uint16, 4), (np.uint16, 3)])
def test_host_block_sum_bit_equal(dtype, k):
    rng = np.random.default_rng(0)
    px = rng.integers(0, np.iinfo(dtype).max + 1, size=(2, 37, 29), dtype=dtype)
    out, ref = resize.host_block_sum(px, k), jax_resize.host_block_sum(px, k)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("in_hw,canvas", [((2294, 1914), (1024, 832)), ((230, 190), (64, 48)),
                                          ((10, 300), (64, 64)), ((5, 5), (16, 12))])
def test_fit_shape_equal(in_hw, canvas):
    assert resize.fit_shape(in_hw, canvas) == jax_resize.fit_shape(in_hw, canvas)


@pytest.mark.parametrize("method", ["area", "bilinear"])
@pytest.mark.parametrize("shape,out_hw", [((2, 57, 91), (16, 20)), ((1, 230, 190), (64, 48)),
                                          ((2, 20, 30, 3), (8, 12))])
def test_resize2d_highest_matches_jax(method, shape, out_hw):
    x = np.random.default_rng(1).uniform(0, 65535, size=shape).astype(np.float32)
    ref = np.asarray(jax_resize.resize2d(jnp.asarray(x), out_hw, method=method))
    out = resize.resize2d(torch.from_numpy(x), out_hw, method=method, precision="highest").numpy()
    np.testing.assert_allclose(out / 65535, ref / 65535, atol=TOL)


def test_resize_to_canvas_matches_jax():
    px = np.random.default_rng(2).integers(0, 65536, size=(2, 230, 190), dtype=np.uint16)
    ref, ref_valid = jax_resize.resize_to_canvas(jnp.asarray(px), (64, 64))
    out, valid = resize.resize_to_canvas(torch.from_numpy(px), (64, 64), precision="highest")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(out.numpy() / 65535, np.asarray(ref) / 65535, atol=TOL)


@pytest.mark.parametrize("dtype,k", [(np.uint8, 4), (np.uint16, 2), (np.uint16, 3)])
def test_resize_from_block_sums_matches_jax(dtype, k):
    px = np.random.default_rng(3).integers(0, np.iinfo(dtype).max + 1, size=(2, 233, 191),
                                           dtype=dtype)
    sums = resize.host_block_sum(px, k)
    ref, ref_valid = jax_resize.resize_to_canvas_from_block_sums(
        jnp.asarray(sums), (233, 191), (64, 48), k)
    port_sums = sums.view(np.int32) if sums.dtype == np.uint32 else sums
    out, valid = resize.resize_to_canvas_from_block_sums(
        torch.from_numpy(port_sums), (233, 191), (64, 48), k, precision="highest")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    top = float(np.iinfo(dtype).max)
    np.testing.assert_allclose(out.numpy() / top, np.asarray(ref) / top, atol=TOL)


def test_default_precision_within_the_truncation_bound():
    """bf16 operands with fp32 sums, against the exact fp32 resample, after
    full-range normalisation: the bound of tests/test_resize.py:271."""
    x = np.random.default_rng(7).integers(0, 65536, size=(2, 230, 190), dtype=np.uint16)
    exact = np.asarray(jax_resize.resize2d(jnp.asarray(x, jnp.float32), (64, 48), method="area"))
    trunc = resize.resize2d(torch.from_numpy(x.astype(np.float32)), (64, 48)).numpy()
    err = np.abs(trunc - exact) / 32767.5
    assert err.max() < 1.2e-2, err.max()
    assert np.mean(err) < 6e-3, err.mean()
    assert err.max() > 0  # the default really is the single bf16 pass


def test_default_precision_is_the_tpu_single_pass():
    """The default product equals the JAX test's simulation of the TPU pass
    (bf16 operands, fp32 accumulation) on the same inputs."""
    x = np.random.default_rng(8).integers(0, 65536, size=(1, 50, 40), dtype=np.uint16)
    rh = jnp.asarray(jax_resize._resize_weights(50, 16, "area"), jnp.bfloat16)
    rw = jnp.asarray(jax_resize._resize_weights(40, 12, "area"), jnp.bfloat16)
    y = jnp.einsum("oh,nhw->now", rh, jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    y = jnp.einsum("pw,now->nop", rw, y.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    out = resize.resize2d(torch.from_numpy(x), (16, 12)).numpy()
    np.testing.assert_allclose(out, np.asarray(y), rtol=1e-6, atol=1e-2)
