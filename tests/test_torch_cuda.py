"""The port's CUDA kernels on the card, held against their plain versions.

These need a CUDA card and ``nvcc``; without them every test skips (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
machine without it, where the repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: fp32 1e-4 relative to the largest output (the block kernel) and
1e-5 absolute (attention), TF32 off; bf16 two bf16 steps of the largest
output (the two sides round at different points).
"""

import numpy as np
import pytest
import torch

from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    launch_flash_attention,
)
from mmgclip_tpu_torch.ops.fused_block import (
    fused_convnext_block,
    launch_fused_block,
    plain_convnext_block,
)

pytestmark = pytest.mark.cuda

BLOCK_FP32_REL_TOL = 1e-4
FLASH_FP32_ABS_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def block_inputs(shape, dtype, device, seed=0):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    x = f(n, h, w, c).to(device, dtype)
    params = [f(7, 7, 1, c, scale=0.2), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
              f(c, 4 * c, scale=c ** -0.5), f(4 * c, scale=0.1), f(4 * c, c, scale=(4 * c) ** -0.5),
              f(c, scale=0.1), f(c, scale=0.5)]
    return x, [t.to(device, torch.float32 if i in (2, 3) else dtype) for i, t in enumerate(params)]


@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (2, 13, 11, 32), (1, 1, 1, 96),
                                   (1, 64, 52, 96), (2, 64, 52, 384), (2, 8, 7, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_block_kernel_matches_plain(cuda_device, shape, dtype, gelu_tanh):
    x, params = block_inputs(shape, dtype, cuda_device)
    before = launch_counts()["fused_convnext_block"]
    out = launch_fused_block(x, *params, gelu_tanh=gelu_tanh).float()
    assert launch_counts()["fused_convnext_block"] == before + 1
    ref = plain_convnext_block(x, *params, gelu_tanh=gelu_tanh).float()
    tol = BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_block_backward_runs_the_plain_math(cuda_device):
    x, params = block_inputs((1, 6, 5, 8), torch.float32, cuda_device, seed=1)
    leaves = [t.requires_grad_(True) for t in [x, *params]]
    grads = torch.autograd.grad(fused_convnext_block(*leaves).sum(), leaves)
    ref = torch.autograd.grad(plain_convnext_block(*leaves).sum(), leaves)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r)


def test_block_kernel_refuses_channels_it_does_not_take(cuda_device):
    x, params = block_inputs((1, 4, 4, 6), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="C % 4"):
        launch_fused_block(x, *params)


def qkv(b, h, s, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("s", [1, 32, 77, 128, 256])
@pytest.mark.parametrize("d", [64, 128, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_reference(cuda_device, s, d, dtype):
    lengths = [0, 1, min(37, s), s]
    q, k, v = qkv(4, 3, s, d, dtype, cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    mask = torch.arange(s, device=cuda_device)[None, :] < lens[:, None]
    out = launch_flash_attention(q, k, v, lens).float()
    ref = attention_reference(q, k, v, mask).float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= FLASH_FP32_ABS_TOL
    else:
        assert err <= BF16_REL_TOL * ref.abs().max().item()


def test_flash_routes_a_non_prefix_mask_to_the_reference(cuda_device):
    q, k, v = qkv(2, 2, 32, 64, torch.float32, cuda_device, seed=2)
    mask = torch.ones(2, 32, dtype=torch.int32, device=cuda_device)
    mask[1, 3] = 0
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, mask)
    assert launch_counts()["flash_attention"] == before
    torch.testing.assert_close(out, attention_reference(q, k, v, mask))


def test_flash_backward_runs_the_plain_math(cuda_device):
    q, k, v = (t.requires_grad_(True) for t in qkv(2, 2, 16, 64, torch.float32, cuda_device, seed=3))
    mask = torch.arange(16, device=cuda_device)[None, :] < torch.tensor([16, 9], device=cuda_device)[:, None]
    grads = torch.autograd.grad(flash_attention(q, k, v, mask).sum(), (q, k, v))
    ref = torch.autograd.grad(attention_reference(q, k, v, mask).sum(), (q, k, v))
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
