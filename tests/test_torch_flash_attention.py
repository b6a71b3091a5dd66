"""The port's attention against the JAX package's.

``attention_reference`` (the port's plain version, what CPU tensors run) is
held against JAX ``attention_reference`` and the JAX Pallas flash kernel in
interpret mode at s=128 with valid lengths {0, 1, 37, 128}.  The CUDA
kernel runs only on a card: its tests are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.ops.flash_attention import (
    attention_reference as jax_reference,
    flash_attention as jax_flash,
)
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    launch_flash_attention,
    prefix_lengths,
)

FP32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -5
LENGTHS = [0, 1, 37, 128]


def make_qkv(b=4, h=2, s=128, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def prefix_mask(lengths, s):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


def test_reference_matches_jax_reference_fp32():
    q, k, v = make_qkv()
    mask = prefix_mask(LENGTHS, 128)
    ref = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
    out = attention_reference(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_reference_matches_jax_reference_bf16():
    q, k, v = make_qkv(seed=1)
    mask = prefix_mask(LENGTHS, 128)
    ref = np.asarray(jax_reference(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                   jnp.asarray(mask)), np.float32)
    out = attention_reference(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
                              torch.from_numpy(mask)).float().numpy()
    assert np.abs(out - ref).max() <= BF16_REL_TOL * np.abs(ref).max()


def test_reference_matches_jax_flash_kernel_interpret():
    q, k, v = make_qkv(seed=2)
    mask = prefix_mask(LENGTHS, 128)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask), interpret=True))
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_zero_length_rows_attend_uniformly():
    q, k, v = make_qkv(b=1, s=16, seed=3)
    out = attention_reference(*map(torch.from_numpy, (q, k, v)), torch.zeros(1, 16, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape),
                               atol=FP32_TOL)


def test_non_prefix_mask_routes_to_the_exact_path():
    q, k, v = make_qkv(seed=4)
    mask = prefix_mask(LENGTHS, 128)
    mask[2, 5] = 0  # a hole: not a contiguous prefix
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask), interpret=True))
    tmask = torch.from_numpy(mask)
    assert prefix_lengths(tmask, 128) is None
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), tmask).numpy()
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_prefix_lengths_and_lengths_argument():
    q, k, v = map(torch.from_numpy, make_qkv(seed=5))
    mask = torch.from_numpy(prefix_mask(LENGTHS, 128))
    lengths = prefix_lengths(mask, 128)
    assert lengths.dtype == torch.int32 and lengths.tolist() == LENGTHS
    before = launch_counts()["flash_attention"]
    torch.testing.assert_close(flash_attention(q, k, v, lengths=lengths),
                               flash_attention(q, k, v, mask), rtol=0, atol=0)
    assert launch_counts()["flash_attention"] == before  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask, lengths=lengths)


def test_launch_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=8))
    with pytest.raises(ValueError, match="CUDA"):
        launch_flash_attention(q, k, v, torch.tensor([8], dtype=torch.int32))

