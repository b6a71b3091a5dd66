"""The port's ConvNeXt block against the JAX package's.

``plain_convnext_block`` (the port's plain version, what CPU tensors run) is
held against JAX ``_lax_block`` and against the JAX Pallas kernel in
interpret mode, on the same numpy inputs.  The CUDA kernel itself only runs
on a card: its tests are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.ops.fused_block import _lax_block, fused_convnext_block as jax_fused
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.fused_block import (
    _check_args,
    fused_convnext_block,
    launch_fused_block,
    plain_convnext_block,
)

FP32_TOL = 1e-5  # fp32, same math, different summation order
BF16_REL_TOL = 2.0 ** -5  # bf16: a few bf16 steps of the largest output value

SHAPES = [(1, 7, 5, 8), (2, 13, 11, 32), (1, 16, 16, 8), (1, 5, 7, 32)]


def make_inputs(shape, seed=0):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = f(n, h, w, c)
    params = [f(7, 7, 1, c, scale=0.2), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
              f(c, 4 * c, scale=c ** -0.5), f(4 * c, scale=0.1), f(4 * c, c, scale=(4 * c) ** -0.5),
              f(c, scale=0.1), f(c, scale=0.5)]
    return x, params


def torch_args(x, params, dtype):
    """numpy inputs -> the port's argument list (LN affine stays fp32)."""
    tx = torch.from_numpy(x).to(dtype)
    tp = [torch.from_numpy(p).to(torch.float32 if i in (2, 3) else dtype) for i, p in enumerate(params)]
    return tx, tp


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_plain_block_matches_jax_lax_block_fp32(shape, gelu_tanh):
    x, params = make_inputs(shape)
    ref = np.asarray(_lax_block(jnp.asarray(x), *map(jnp.asarray, params), gelu_tanh=gelu_tanh))
    tx, tp = torch_args(x, params, torch.float32)
    out = plain_convnext_block(tx, *tp, gelu_tanh=gelu_tanh).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_plain_block_matches_jax_lax_block_bf16(shape, gelu_tanh):
    x, params = make_inputs(shape, seed=1)
    jargs = [jnp.asarray(p, jnp.float32 if i in (2, 3) else jnp.bfloat16) for i, p in enumerate(params)]
    ref = np.asarray(_lax_block(jnp.asarray(x, jnp.bfloat16), *jargs, gelu_tanh=gelu_tanh), np.float32)
    tx, tp = torch_args(x, params, torch.bfloat16)
    out = plain_convnext_block(tx, *tp, gelu_tanh=gelu_tanh).float().numpy()
    assert np.abs(out - ref).max() <= BF16_REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_plain_block_matches_jax_pallas_kernel_interpret(shape, gelu_tanh):
    """The JAX kernel itself (interpret mode) is the other oracle."""
    x, params = make_inputs(shape, seed=2)
    ref = np.asarray(jax_fused(jnp.asarray(x), *map(jnp.asarray, params), True, gelu_tanh))
    tx, tp = torch_args(x, params, torch.float32)
    out = plain_convnext_block(tx, *tp, gelu_tanh=gelu_tanh).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    x, params = make_inputs((1, 6, 9, 8), seed=3)
    tx, tp = torch_args(x, params, torch.float32)
    before = launch_counts()["fused_convnext_block"]
    out = fused_convnext_block(tx, *tp)
    assert torch.equal(out, plain_convnext_block(tx, *tp))
    assert launch_counts()["fused_convnext_block"] == before


def test_plain_block_gradient_matches_jax():
    x, params = make_inputs((1, 5, 6, 8), seed=4)
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _lax_block(*a), jnp.asarray(x), *map(jnp.asarray, params))
    jgrads = vjp(jnp.asarray(ct))
    tx, tp = torch_args(x, params, torch.float32)
    leaves = [t.requires_grad_(True) for t in [tx, *tp]]
    out = fused_convnext_block(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)


def test_launch_refuses_cpu_tensors():
    x, params = make_inputs((1, 4, 4, 8))
    tx, tp = torch_args(x, params, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        launch_fused_block(tx, *tp)


@pytest.mark.parametrize("case", ["channels", "dtype", "shape", "ln_dtype"])
def test_argument_checks_raise(case):
    x, params = make_inputs((1, 4, 4, 8))
    tx, tp = torch_args(x, params, torch.float32)
    if case == "channels":
        tx = torch.zeros(1, 4, 4, 6)
        tp = [torch.zeros(7, 7, 1, 6)] + [torch.zeros(6)] * 8
    elif case == "dtype":
        tx = tx.double()
    elif case == "shape":
        tp[4] = tp[4][:, :-1]
    else:
        tp[2] = tp[2].to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        _check_args(tx, *tp)

