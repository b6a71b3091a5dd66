"""The plain versions of the port's stem, downsample, depthwise and int8 block
kernels (what CPU tensors run, and each kernel's yardstick on the card)
against the JAX package's lax math and its Pallas kernels in interpret mode,
on the same numpy inputs.  The CUDA kernels themselves are held against these
plain versions in ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 1e-5 (same math, other summation order); int8 as
``tests/test_quant.py`` bounds it (block relative error < 0.05; the JAX
kernel's scale partition follows its VMEM tiling, the port's is per pixel,
so they cannot agree bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.ops.depthwise_conv import depthwise_conv7x7 as jax_dwconv
from mmgclip_tpu.ops.fused_block import _lax_block_int8
from mmgclip_tpu.ops.fused_block import fused_convnext_block_int8 as jax_block_int8
from mmgclip_tpu.ops.fused_downsample import _lax_ln_downsample
from mmgclip_tpu.ops.fused_downsample import fused_ln_downsample as jax_downsample
from mmgclip_tpu.ops.fused_stem import _lax_stem
from mmgclip_tpu.ops.fused_stem import fused_stem as jax_stem
from mmgclip_tpu.ops.quant import int8_dot as jax_int8_dot
from mmgclip_tpu.ops.quant import int8_quantize as jax_int8_quantize
from mmgclip_tpu_torch.ops.depthwise_conv import depthwise_conv7x7, plain_depthwise_conv7x7
from mmgclip_tpu_torch.ops.fused_block import (
    fused_convnext_block_int8,
    plain_convnext_block_int8,
    quantize_rows,
)
from mmgclip_tpu_torch.ops.fused_downsample import fused_ln_downsample, plain_ln_downsample
from mmgclip_tpu_torch.ops.fused_stem import fused_stem, patchify, plain_stem
from mmgclip_tpu_torch.ops.quant import int8_dot, int8_matmul, int8_quantize

FP32_TOL = 1e-5
INT8_BLOCK_REL = 0.05


def arrays(seed, *shapes, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return [(offset + rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---- stem ----------------------------------------------------------------

@pytest.mark.parametrize("shape,cout", [((2, 32, 32, 1), 96), ((1, 30, 27, 1), 96),
                                        ((1, 16, 24, 3), 64), ((1, 5, 7, 3), 96)])
def test_plain_stem_matches_jax_lax_and_interpret(shape, cout):
    cin = shape[-1]
    x, k, b, ns, nb = arrays(1, shape, (4, 4, cin, cout), (cout,), (cout,), (cout,), scale=0.3)
    ns = ns + 1.0
    out = plain_stem(t(x), t(k), t(b), t(ns), t(nb)).numpy()
    lax = np.asarray(_lax_stem(*map(jnp.asarray, (x, k, b, ns, nb))))
    kernel = np.asarray(jax_stem(*map(jnp.asarray, (x, k, b, ns, nb)), True))
    assert out.shape == lax.shape == kernel.shape
    np.testing.assert_allclose(out, lax, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(out, kernel, atol=FP32_TOL, rtol=FP32_TOL)
    # a CPU tensor routes to the plain version
    np.testing.assert_array_equal(fused_stem(t(x), t(k), t(b), t(ns), t(nb)).numpy(), out)


def test_patchify_geometry():
    x = torch.arange(1 * 6 * 7 * 2, dtype=torch.float32).reshape(1, 6, 7, 2)
    assert patchify(x, 2).shape == (1, 3, 4, 8)
    p = patchify(x, 4)
    assert p.shape == (1, 2, 2, 32)
    # patch (0, 1), row dy=1, col dx=2, channel 1 -> flat index (dy*4+dx)*2+1
    assert p[0, 0, 1, (1 * 4 + 2) * 2 + 1] == x[0, 1, 4 + 2, 1]
    assert p[0, 1, 1, -1] == 0  # the bottom/right pad


def test_plain_stem_rounds_patches_to_the_weight_dtype():
    """bf16 weights: the patches are rounded to bf16 before the fp32 product,
    as the JAX kernel casts them; the result keeps x's dtype."""
    x, k, b = arrays(2, (1, 9, 10, 1), (4, 4, 1, 96), (96,), scale=0.5)
    ns, nb = np.ones(96, np.float32), np.zeros(96, np.float32)
    out = plain_stem(t(x), t(k, torch.bfloat16), t(b, torch.bfloat16), t(ns), t(nb))
    assert out.dtype == torch.float32
    ref = plain_stem(t(x).to(torch.bfloat16).float(), t(k, torch.bfloat16).float(),
                     t(b, torch.bfloat16).float(), t(ns), t(nb))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


# ---- downsample ------------------------------------------------------------

@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 32), 64), ((1, 15, 13, 32), 64),
                                        ((1, 7, 9, 16), 32), ((1, 1, 1, 8), 16)])
def test_plain_downsample_matches_jax_lax_and_interpret(shape, cout):
    cin = shape[-1]
    x, ns, nb, k, b = arrays(3, shape, (cin,), (cin,), (2, 2, cin, cout), (cout,), scale=0.3)
    ns = ns + 1.0
    out = plain_ln_downsample(t(x), t(ns), t(nb), t(k), t(b)).numpy()
    lax = np.asarray(_lax_ln_downsample(*map(jnp.asarray, (x, ns, nb, k, b))))
    kernel = np.asarray(jax_downsample(*map(jnp.asarray, (x, ns, nb, k, b)), True))
    assert out.shape == lax.shape == kernel.shape == (shape[0], -(-shape[1] // 2),
                                                      -(-shape[2] // 2), cout)
    np.testing.assert_allclose(out, lax, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(out, kernel, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(fused_ln_downsample(t(x), t(ns), t(nb), t(k), t(b)).numpy(),
                                  out)


# ---- depthwise -------------------------------------------------------------

@pytest.mark.parametrize("shape,interpret", [((2, 9, 11, 128), True), ((1, 8, 8, 96), False),
                                             ((1, 3, 5, 96), False)])
def test_plain_depthwise_matches_jax(shape, interpret):
    """C = 128 reaches the JAX Pallas kernel (interpret); C = 96 its lax path."""
    c = shape[-1]
    x, w, b = arrays(4, shape, (7, 7, 1, c), (c,), scale=0.5)
    ref = np.asarray(jax_dwconv(*map(jnp.asarray, (x, w, b)), interpret=interpret))
    out = plain_depthwise_conv7x7(t(x), t(w), t(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(depthwise_conv7x7(t(x), t(w), t(b)).numpy(), out)


# ---- int8 ------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, -1])
def test_int8_quantize_bit_equal_to_jax(axis):
    (x,) = arrays(5, (16, 32))
    x[0, :3] = [0.5, -1.5, 2.5]  # half-way cases of the scaled values are rare;
    q, s = int8_quantize(t(x), axis=axis)
    jq, js = jax_int8_quantize(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_round_half_to_even_like_jnp_round():
    v = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(t(v)).numpy(), np.asarray(jnp.round(v)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_dot_bit_equal_to_jax(out_dtype):
    x, w = arrays(6, (4, 8, 8, 32), (32, 64))
    w = w * 0.05
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(w), out_dtype=jdt), np.float32)
    out = int8_dot(t(x), t(w), out_dtype=out_dtype).float().numpy()
    np.testing.assert_array_equal(out, ref)


def test_int8_matmul_accumulates_exactly():
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, size=(5, 3072)).astype(np.int8)
    b = rng.integers(-127, 128, size=(3072, 7)).astype(np.int8)
    out = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_quantize_rows_uses_the_kernel_scale_formula():
    (v,) = arrays(8, (3, 5, 24))
    v[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    q, s = quantize_rows(t(v))
    amax = np.maximum(np.abs(v).max(-1, keepdims=True), np.float32(1e-8))
    np.testing.assert_array_equal(s.numpy(), amax * np.float32(1.0 / 127.0))
    np.testing.assert_array_equal(q.numpy(), np.clip(np.round(v / s.numpy()), -127, 127))


def block_arrays(shape, seed=9):
    n, h, w, c = shape
    x, dwk, dwb, ns, nb, w1, b1, w2, b2, g = arrays(
        seed, shape, (7, 7, 1, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,), (c,))
    return [x, dwk * 0.2, dwb * 0.1, 1 + ns * 0.1, nb * 0.1, w1 * c ** -0.5, b1 * 0.1,
            w2 * (4 * c) ** -0.5, b2 * 0.1, g * 0.5]


@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (2, 13, 11, 32), (1, 16, 16, 8)])
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_plain_int8_block_within_the_quant_bound_of_jax(shape, gelu_tanh):
    args = block_arrays(shape)
    out = plain_convnext_block_int8(*map(t, args), gelu_tanh=gelu_tanh).numpy()
    jargs = list(map(jnp.asarray, args))
    for ref in (np.asarray(_lax_block_int8(*jargs, gelu_tanh=gelu_tanh)),
                np.asarray(jax_block_int8(*jargs, True, gelu_tanh))):
        # the block's own term (the residual x would hide its error)
        rel = np.abs((out - args[0]) - (ref - args[0])).max() / np.abs(ref - args[0]).max()
        assert rel < INT8_BLOCK_REL, rel
    np.testing.assert_array_equal(
        fused_convnext_block_int8(*map(t, args), gelu_tanh=gelu_tanh).numpy(), out)


def test_int8_block_scales_are_per_pixel():
    """A pixel's output depends on its own scale only: changing another
    pixel's magnitude (outside the 7x7 window) leaves it bit-identical."""
    args = block_arrays((1, 1, 16, 8), seed=10)
    base = plain_convnext_block_int8(*map(t, args)).numpy()
    args[0] = args[0].copy()
    args[0][0, 0, 15] *= 100.0
    moved = plain_convnext_block_int8(*map(t, args)).numpy()
    np.testing.assert_array_equal(base[0, 0, :8], moved[0, 0, :8])
