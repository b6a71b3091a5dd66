"""The port's CUDA kernels on the card, held against their plain versions.

These need a CUDA card and ``nvcc``; without them every test skips (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
machine without it, where the repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: fp32 1e-4 relative to the largest output (the block, stem,
downsample and depthwise kernels) and 1e-5 absolute (attention), TF32 off;
bf16 two bf16 steps of the largest output (the two sides round at different
points); the int8 block 2**-5 relative against its same-partition plain
version (a rounding flip moves a value by one quantisation step).
"""

import numpy as np
import pytest
import torch

from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.depthwise_conv import (
    depthwise_conv7x7,
    launch_depthwise_conv7x7,
    plain_depthwise_conv7x7,
)
from mmgclip_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    launch_flash_attention,
)
from mmgclip_tpu_torch.ops.fused_block import (
    fused_convnext_block,
    fused_convnext_block_int8,
    launch_fused_block,
    launch_fused_block_int8,
    plain_convnext_block,
    plain_convnext_block_int8,
)
from mmgclip_tpu_torch.ops.fused_downsample import (
    fused_ln_downsample,
    launch_fused_ln_downsample,
    plain_ln_downsample,
)
from mmgclip_tpu_torch.ops.fused_stem import fused_stem, launch_fused_stem, plain_stem

pytestmark = pytest.mark.cuda

BLOCK_FP32_REL_TOL = 1e-4
FLASH_FP32_ABS_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -6
INT8_REL_TOL = 2.0 ** -5


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


def tensor(rng, *shape, scale=1.0, offset=0.0):
    return torch.from_numpy((offset + rng.standard_normal(shape) * scale).astype(np.float32))


def assert_rel(out, ref, tol):
    out, ref = out.float(), ref.float()
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (2, 13, 11, 32), (1, 1, 1, 96),
                                   (1, 64, 52, 96), (2, 8, 7, 768), (1, 20, 17, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_int8_block_kernel_matches_plain(cuda_device, shape, dtype, gelu_tanh):
    x, params = block_inputs(shape, dtype, cuda_device, seed=4)
    before = launch_counts()["fused_convnext_block_int8"]
    out = launch_fused_block_int8(x, *params, gelu_tanh=gelu_tanh)
    assert launch_counts()["fused_convnext_block_int8"] == before + 1
    ref = plain_convnext_block_int8(x, *params, gelu_tanh=gelu_tanh)
    assert out.dtype == dtype
    # the residual dominates x + gamma * mlp: hold the block's own term
    assert_rel(out.float() - x.float(), ref.float() - x.float(), INT8_REL_TOL)


@pytest.mark.parametrize("shape", [(1, 7, 5, 1), (2, 13, 11, 3), (1, 1, 1, 3), (1, 64, 52, 1),
                                   (1, 130, 97, 3)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_stem_kernel_matches_plain(cuda_device, shape, dtypes):
    x_dtype, w_dtype = dtypes
    rng = np.random.default_rng(5)
    cin, cout = shape[-1], 96
    x = tensor(rng, *shape).to(cuda_device, x_dtype)
    k = tensor(rng, 4, 4, cin, cout, scale=(16 * cin) ** -0.5).to(cuda_device, w_dtype)
    b = tensor(rng, cout, scale=0.1).to(cuda_device, w_dtype)
    ns = tensor(rng, cout, scale=0.1, offset=1.0).to(cuda_device)
    nb = tensor(rng, cout, scale=0.1).to(cuda_device)
    before = launch_counts()["fused_stem"]
    out = launch_fused_stem(x, k, b, ns, nb)
    assert launch_counts()["fused_stem"] == before + 1
    ref = plain_stem(x, k, b, ns, nb)
    assert out.shape == ref.shape and out.dtype == x_dtype
    assert_rel(out, ref, BLOCK_FP32_REL_TOL if x_dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("shape,cout", [((1, 7, 5, 8), 16), ((2, 13, 11, 32), 64),
                                        ((1, 1, 1, 96), 192), ((1, 64, 52, 96), 192),
                                        ((1, 9, 7, 384), 768), ((1, 287, 240, 192), 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_downsample_kernel_matches_plain(cuda_device, shape, cout, dtype):
    rng = np.random.default_rng(6)
    cin = shape[-1]
    x = tensor(rng, *shape).to(cuda_device, dtype)
    ns = tensor(rng, cin, scale=0.1, offset=1.0).to(cuda_device)
    nb = tensor(rng, cin, scale=0.1).to(cuda_device)
    k = tensor(rng, 2, 2, cin, cout, scale=(4 * cin) ** -0.5).to(cuda_device, dtype)
    b = tensor(rng, cout, scale=0.1).to(cuda_device, dtype)
    before = launch_counts()["fused_ln_downsample"]
    out = launch_fused_ln_downsample(x, ns, nb, k, b)
    assert launch_counts()["fused_ln_downsample"] == before + 1
    ref = plain_ln_downsample(x, ns, nb, k, b)
    assert out.shape == ref.shape
    assert_rel(out, ref, BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (2, 13, 11, 32), (1, 1, 1, 96), (1, 5, 9, 6),
                                   (1, 64, 52, 96), (2, 8, 7, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_matches_plain(cuda_device, shape, dtype):
    rng = np.random.default_rng(7)
    c = shape[-1]
    x = tensor(rng, *shape).to(cuda_device, dtype)
    w = tensor(rng, 7, 7, 1, c, scale=0.2).to(cuda_device, dtype)
    b = tensor(rng, c, scale=0.1).to(cuda_device, dtype)
    before = launch_counts()["depthwise_conv7x7"]
    out = launch_depthwise_conv7x7(x, w, b)
    assert launch_counts()["depthwise_conv7x7"] == before + 1
    assert_rel(out, plain_depthwise_conv7x7(x, w, b),
               BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("kind", ["stem", "downsample", "depthwise", "int8"])
def test_glue_backward_runs_the_plain_math(cuda_device, kind):
    rng = np.random.default_rng(9)
    if kind == "stem":
        args = [tensor(rng, 1, 9, 10, 3), tensor(rng, 4, 4, 3, 16), tensor(rng, 16),
                tensor(rng, 16, offset=1.0), tensor(rng, 16)]
        public, plain = fused_stem, plain_stem
    elif kind == "downsample":
        args = [tensor(rng, 1, 7, 5, 8), tensor(rng, 8, offset=1.0), tensor(rng, 8),
                tensor(rng, 2, 2, 8, 16), tensor(rng, 16)]
        public, plain = fused_ln_downsample, plain_ln_downsample
    elif kind == "depthwise":
        args = [tensor(rng, 1, 6, 5, 8), tensor(rng, 7, 7, 1, 8), tensor(rng, 8)]
        public, plain = depthwise_conv7x7, plain_depthwise_conv7x7
    else:
        x, params = block_inputs((1, 6, 5, 8), torch.float32, "cpu", seed=2)
        args = [x, *params]
        public, plain = fused_convnext_block_int8, plain_convnext_block_int8
    leaves = [a.to(cuda_device).requires_grad_(True) for a in args]
    before = launch_counts()
    grads = torch.autograd.grad(public(*leaves).sum(), leaves, allow_unused=True)
    assert sum(launch_counts().values()) == sum(before.values()) + 1
    ref = torch.autograd.grad(plain(*leaves).sum(), leaves, allow_unused=True)
    for g, r in zip(grads, ref):
        if r is None:
            assert g is None or not g.abs().max()
        else:
            torch.testing.assert_close(g, r)


def _cpu_calls():
    rng = np.random.default_rng(8)
    x, params = block_inputs((1, 4, 4, 8), torch.float32, "cpu")
    img = tensor(rng, 1, 8, 8, 1)
    return {
        "fused_convnext_block": lambda: launch_fused_block(x, *params),
        "fused_convnext_block_int8": lambda: launch_fused_block_int8(x, *params),
        "fused_stem": lambda: launch_fused_stem(img, tensor(rng, 4, 4, 1, 8), torch.zeros(8),
                                                torch.ones(8), torch.zeros(8)),
        "fused_ln_downsample": lambda: launch_fused_ln_downsample(
            x, torch.ones(8), torch.zeros(8), tensor(rng, 2, 2, 8, 16), torch.zeros(16)),
        "depthwise_conv7x7": lambda: launch_depthwise_conv7x7(x, params[0], params[1]),
        "flash_attention": lambda: launch_flash_attention(
            *qkv(1, 1, 4, 8, torch.float32, "cpu"), torch.tensor([4], dtype=torch.int32)),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_every_launcher_refuses_cpu_tensors(name):
    before = launch_counts()[name]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _cpu_calls()[name]()
    assert launch_counts()[name] == before
