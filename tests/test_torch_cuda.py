"""The port's CUDA kernels on the card, held against their plain versions.

These need a CUDA card and ``nvcc``; without them every test skips (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
machine without it, where the repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: fp32 1e-4 relative to the largest output (the block, stem,
downsample and depthwise kernels) and 1e-5 absolute (attention), TF32 off;
a second launch of the block, the int8 block and the downsample on the same
inputs bit-equal to the first;
bf16 two bf16 steps of the largest output (the two sides round at different
points); the int8 block 2**-5 relative against its same-partition plain
version (a rounding flip moves a value by one quantisation step); the ring
all-gather bit-equal (it copies), and the global losses through it within
1e-6 relative (loss) and 1e-5 (gradients) of the single-device losses; the
product gates of ``chip_smoke.py`` phase 15 (zero-shot AUC within 0.005 and
byte-identical reports for every speed knob of the tower); the fused epoch
as a CUDA graph against the eager epoch, and a resume after the capture
against an unbroken run, within 1e-6 relative (losses and params); the exam
family's ``encode_studies`` launching the store preset's kernels per
program call; the threefry and dropout kernels bit-equal to their plain
versions (``utils/prng.py``): keys, masks, outputs and gradients, also
replayed in a CUDA graph; the micro ResNet tower on the card against the
CPU within 1e-5 relative L2 (features and ``layer4`` gradients), and its
fused epoch graphed and resumed after the capture as above; the t-SNE on
the card against the CPU (KL within 1% relative, trustworthiness within
0.01); ``convert_convnext --verify`` on the card within 1e-4, and the three
converters writing the same bytes with the card as with ``--device cpu``;
the ring all-gather across 2 and 4 processes sharing the card (gloo)
bit-equal to ``torch.cat`` with one launch a call, its workspaces mapped and
freed, a withheld hand-off and a rank that dies each raising within the
deadline instead of hanging.
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
from mmgclip_tpu_torch.ops.dropout import dropout, launch_dropout, launch_threefry2x32, plain_dropout
from mmgclip_tpu_torch.ops.dropout import fold_in as device_fold_in
from mmgclip_tpu_torch.ops.dropout import split as device_split
from mmgclip_tpu_torch.ops.fused_stem import fused_stem, launch_fused_stem, plain_stem
from mmgclip_tpu_torch.parallel import (
    check_ring,
    global_clip_loss,
    global_mmgclip_loss,
    launch_ring_all_gather,
    ring_all_gather_diff,
    ring_all_gather_plain,
)
from mmgclip_tpu_torch.parallel.collectives import _launch_ring
from mmgclip_tpu_torch.utils import prng

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


# C = 8 and 16 pad the mma's K (the micro tower); (3, 5, 7, 96) ends inside a
# row tile that straddles images; C = 20 is not a multiple of 16, and its
# bf16 rows of W2 are not 16-byte aligned (plain loads); (1, 574, 479, 96)
# is the full-field stage 1
@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (1, 4, 4, 16), (2, 13, 11, 32), (1, 1, 1, 96),
                                   (1, 64, 52, 96), (2, 64, 52, 384), (2, 8, 7, 768),
                                   (2, 32, 26, 768), (32, 1, 1, 768), (3, 5, 7, 96), (2, 13, 11, 20),
                                   (1, 574, 479, 96)])
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


@pytest.mark.parametrize("shape", [(2, 64, 52, 384), (2, 32, 26, 768), (3, 5, 7, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernel_repeats_its_bits(cuda_device, shape, dtype):
    """No atomics and a fixed order of sums: two launches, the same bits."""
    x, params = block_inputs(shape, dtype, cuda_device, seed=3)
    first = launch_fused_block(x, *params)
    second = launch_fused_block(x, *params)
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       second.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_block_kernel_refuses_channels_past_its_tiles(cuda_device):
    x, params = block_inputs((1, 1, 1, 1540), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="C <= 1536"):
        launch_fused_block(x, *params)


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


def assert_flash_close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= FLASH_FP32_ABS_TOL
    else:
        assert err <= BF16_REL_TOL * ref.abs().max().item()


@pytest.mark.parametrize("s", [1, 17, 32, 77, 128, 256, 300])
@pytest.mark.parametrize("d", [64, 128, 40, 17])  # rows of d = 17 are not on 16 bytes: plain loads
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_reference(cuda_device, s, d, dtype):
    # lengths 0 and s, one key, one inside a 32-key tile and one on a tile
    # edge; 5 x 3 (b, head) pairs, so at s <= 32 a CTA holds several pairs
    # and the last CTA a pair slot with no pair
    lengths = [0, 1, min(37, s), min(64, s), s]
    q, k, v = qkv(len(lengths), 3, s, d, dtype, cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    mask = torch.arange(s, device=cuda_device)[None, :] < lens[:, None]
    out = launch_flash_attention(q, k, v, lens)
    assert_flash_close(out, attention_reference(q, k, v, mask), dtype)


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


# C = 8, 16, 20 and 32 pad the mma's K to 32 (the micro tower's 8 / 16 / 32,
# and C = 20 past a multiple of 16); odd H and W; (32, 1, 1, 768) the micro
# tower's last stage, a cluster split; (2, 32, 26, 768) and (1, 574, 479,
# 96) stage shapes of the feature store
@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (1, 5, 7, 16), (2, 13, 11, 20), (2, 13, 11, 32),
                                   (1, 1, 1, 96), (1, 64, 52, 96), (2, 8, 7, 768), (1, 20, 17, 384),
                                   (1, 7, 9, 768), (32, 1, 1, 768), (2, 32, 26, 768),
                                   (1, 574, 479, 96)])
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


def same_bits(a, b):
    return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("shape", [(2, 13, 11, 20), (2, 32, 26, 768), (32, 1, 1, 768),
                                   (1, 64, 52, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_block_kernel_repeats_its_bits(cuda_device, shape, dtype):
    """The row maxima by atomicMax and the int32 partial sums across a
    cluster are order-free: two launches, the same bits."""
    x, params = block_inputs(shape, dtype, cuda_device, seed=5)
    assert same_bits(launch_fused_block_int8(x, *params, gelu_tanh=True),
                     launch_fused_block_int8(x, *params, gelu_tanh=True))


def test_int8_block_kernel_refuses_channels_past_its_tiles(cuda_device):
    x, params = block_inputs((1, 1, 1, 772), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="C <= 768"):
        launch_fused_block_int8(x, *params)


def stem_inputs(shape, cout, dtypes, device, seed=5):
    x_dtype, w_dtype = dtypes
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    return (tensor(rng, *shape).to(device, x_dtype),
            tensor(rng, 4, 4, cin, cout, scale=(16 * cin) ** -0.5).to(device, w_dtype),
            tensor(rng, cout, scale=0.1).to(device, w_dtype),
            tensor(rng, cout, scale=0.1, offset=1.0).to(device), tensor(rng, cout, scale=0.1).to(device))


# odd H and W down to 1 x 1, Cin 1 and 3; (1, 9, 1914, 3): an input row
# pitch of 22,968 bytes, not a multiple of 16 (the full-field width);
# (2, 800, 1000, 3): 1,600 tiles of 64 output pixels, more than the
# persistent CTAs, the last of every row ragged (58 pixels); Cout 8 (the
# micro tower), 20 (not a multiple of 8) and 96
@pytest.mark.parametrize("shape", [(1, 7, 5, 1), (2, 13, 11, 3), (1, 1, 1, 3), (1, 64, 52, 1),
                                   (1, 130, 97, 3), (1, 9, 1914, 3), (2, 800, 1000, 3)])
@pytest.mark.parametrize("cout", [8, 20, 96])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_stem_kernel_matches_plain(cuda_device, shape, cout, dtypes):
    x_dtype = dtypes[0]
    x, k, b, ns, nb = stem_inputs(shape, cout, dtypes, cuda_device)
    before = launch_counts()["fused_stem"]
    out = launch_fused_stem(x, k, b, ns, nb)
    assert launch_counts()["fused_stem"] == before + 1
    ref = plain_stem(x, k, b, ns, nb)
    assert out.shape == ref.shape and out.dtype == x_dtype
    assert_rel(out, ref, BLOCK_FP32_REL_TOL if x_dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("shape,cout", [((1, 9, 1914, 3), 96), ((2, 800, 1000, 3), 96),
                                        ((3, 33, 31, 1), 8), ((1, 13, 270, 3), 20)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_stem_kernel_repeats_its_bits(cuda_device, shape, cout, dtypes):
    x, k, b, ns, nb = stem_inputs(shape, cout, dtypes, cuda_device, seed=7)
    assert same_bits(launch_fused_stem(x, k, b, ns, nb), launch_fused_stem(x, k, b, ns, nb))


@pytest.mark.parametrize("cin,cout", [(5, 96), (3, 264)])
def test_stem_kernel_refuses_channels_past_its_limits(cuda_device, cin, cout):
    x, k, b, ns, nb = stem_inputs((1, 8, 8, cin), cout, (torch.float32, torch.bfloat16), cuda_device)
    with pytest.raises(ValueError, match="Cin <= 4 and Cout <= 256"):
        launch_fused_stem(x, k, b, ns, nb)


def downsample_inputs(shape, cout, dtype, device, seed=6):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    return (tensor(rng, *shape).to(device, dtype), tensor(rng, cin, scale=0.1, offset=1.0).to(device),
            tensor(rng, cin, scale=0.1).to(device),
            tensor(rng, 2, 2, cin, cout, scale=(4 * cin) ** -0.5).to(device, dtype),
            tensor(rng, cout, scale=0.1).to(device, dtype))


# Cin = 8 and 16 (the micro tower; K = 32 and 64), odd H and W, Cout = 20 (not
# a multiple of 8: plain weight loads in bf16), (32, 2, 2, 32) -> 768 the
# micro tower's last, (1, 574, 479, 96) -> 192 the full-field first
@pytest.mark.parametrize("shape,cout", [((1, 7, 5, 8), 16), ((2, 9, 13, 8), 16), ((1, 7, 5, 16), 32),
                                        ((2, 13, 11, 16), 20), ((2, 13, 11, 32), 64),
                                        ((32, 2, 2, 32), 768), ((1, 1, 1, 96), 192),
                                        ((1, 64, 52, 96), 192), ((1, 9, 7, 384), 768),
                                        ((1, 287, 240, 192), 384), ((1, 574, 479, 96), 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_downsample_kernel_matches_plain(cuda_device, shape, cout, dtype):
    x, ns, nb, k, b = downsample_inputs(shape, cout, dtype, cuda_device)
    before = launch_counts()["fused_ln_downsample"]
    out = launch_fused_ln_downsample(x, ns, nb, k, b)
    assert launch_counts()["fused_ln_downsample"] == before + 1
    ref = plain_ln_downsample(x, ns, nb, k, b)
    assert out.shape == ref.shape
    assert_rel(out, ref, BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("shape,cout", [((2, 13, 11, 16), 32), ((1, 287, 240, 192), 384),
                                        ((2, 72, 60, 384), 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_downsample_kernel_repeats_its_bits(cuda_device, shape, cout, dtype):
    args = downsample_inputs(shape, cout, dtype, cuda_device, seed=7)
    assert same_bits(launch_fused_ln_downsample(*args), launch_fused_ln_downsample(*args))


def test_downsample_kernel_refuses_channels_it_does_not_take(cuda_device):
    args = downsample_inputs((1, 4, 4, 6), 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        launch_fused_ln_downsample(*args)


def depthwise_inputs(shape, dtype, device, seed=7):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (tensor(rng, *shape).to(device, dtype), tensor(rng, 7, 7, 1, c, scale=0.2).to(device, dtype),
            tensor(rng, c, scale=0.1).to(device, dtype))


# H, W not multiples of the 16 x 16 tile; C in whole 32-channel slices (32,
# 96, 768), past them (100), below one (3, 6, 8), odd (3), and pixel rows off
# 16 bytes (3, 6 and 100 in bf16), which stage the halo with plain loads
@pytest.mark.parametrize("shape", [(1, 7, 5, 8), (2, 13, 11, 32), (1, 1, 1, 96), (1, 5, 9, 6),
                                   (1, 64, 52, 96), (2, 8, 7, 768), (1, 9, 17, 3), (1, 23, 37, 100),
                                   (1, 574, 479, 96), (2, 32, 26, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_matches_plain(cuda_device, shape, dtype):
    x, w, b = depthwise_inputs(shape, dtype, cuda_device)
    before = launch_counts()["depthwise_conv7x7"]
    out = launch_depthwise_conv7x7(x, w, b)
    assert launch_counts()["depthwise_conv7x7"] == before + 1
    assert_rel(out, plain_depthwise_conv7x7(x, w, b),
               BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.parametrize("case", ["flash float32", "flash bfloat16", "depthwise float32",
                                  "depthwise bfloat16", "block float32", "block bfloat16",
                                  "int8 bfloat16", "downsample bfloat16", "stem float32",
                                  "stem bfloat16"])
def test_back_to_back_launches_stay_exact(cuda_device, case):
    """50 launches queued with no synchronisation, each on new inputs: a
    double-buffered copy that left a stale tile would show at the end."""
    kind, dtype = case.split()
    dtype = getattr(torch, dtype)
    calls = []
    for i in range(50):
        if kind == "flash":
            s = 256
            q, k, v = qkv(8, 12, s, 64, dtype, cuda_device, seed=i)
            lens = torch.tensor([256, 200, 31, 1, 256, 128, 77, 255], dtype=torch.int32,
                                device=cuda_device).roll(i)
            calls.append(((q, k, v, lens), launch_flash_attention(q, k, v, lens)))
        elif kind == "depthwise":
            args = depthwise_inputs((2, 32, 26, 768) if i % 2 else (2, 64, 52, 384), dtype,
                                    cuda_device, seed=i)
            calls.append((args, launch_depthwise_conv7x7(*args)))
        elif kind == "downsample":
            args = downsample_inputs(*(((2, 72, 60, 384), 768) if i % 2 else ((2, 64, 52, 96), 192)),
                                     dtype, cuda_device, seed=i)
            calls.append((args, launch_fused_ln_downsample(*args)))
        elif kind == "stem":  # x in the case's dtype, bf16 weights; the stages wrap
            args = stem_inputs((2, 130, 1000, 3) if i % 2 else (1, 9, 1914, 3), 96,
                               (dtype, torch.bfloat16), cuda_device, seed=i)
            calls.append((args, launch_fused_stem(*args)))
        else:
            x, params = block_inputs((2, 32, 26, 768) if i % 2 else (2, 64, 52, 96), dtype,
                                     cuda_device, seed=i)
            launch = launch_fused_block_int8 if kind == "int8" else launch_fused_block
            calls.append(((x, *params), launch(x, *params)))
    torch.cuda.synchronize()
    tol = BLOCK_FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
    for args, out in calls:
        if kind == "flash":
            q, k, v, lens = args
            mask = torch.arange(q.shape[2], device=cuda_device)[None, :] < lens[:, None]
            assert_flash_close(out, attention_reference(q, k, v, mask), dtype)
        elif kind == "depthwise":
            assert_rel(out, plain_depthwise_conv7x7(*args), tol)
        elif kind == "downsample":
            assert_rel(out, plain_ln_downsample(*args), tol)
        elif kind == "stem":
            assert_rel(out, plain_stem(*args), tol)
        elif kind == "int8":
            x = args[0].float()
            assert_rel(out.float() - x, plain_convnext_block_int8(*args).float() - x, INT8_REL_TOL)
        else:
            assert_rel(out, plain_convnext_block(*args), tol)


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
        "ring_all_gather": lambda: launch_ring_all_gather([torch.zeros(2, 3), torch.ones(2, 3)]),
        "threefry2x32": lambda: launch_threefry2x32(prng.key(0), 0, 2),
        "dropout": lambda: launch_dropout(x, prng.key(0), 1, 0.5),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_every_launcher_refuses_cpu_tensors(name):
    before = launch_counts()[name]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _cpu_calls()[name]()
    assert launch_counts()[name] == before


# ----------------------------------------------------------------------
# ring all-gather

def ring_shards(ranks, shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
                for _ in range(ranks)]
    return [torch.from_numpy(rng.integers(-100, 100, size=shape)).to(device, dtype) for _ in range(ranks)]


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape,dtype", [((32, 512), torch.float32), ((32, 512), torch.bfloat16),
                                         ((256, 768), torch.float32), ((5, 100), torch.float32),
                                         ((7, 3), torch.int8), ((3,), torch.float64),
                                         ((4, 6), torch.float16)])
def test_ring_kernel_is_bit_equal_to_plain(cuda_device, ranks, shape, dtype):
    shards = ring_shards(ranks, shape, dtype, cuda_device)
    before = launch_counts()["ring_all_gather"]
    outs = launch_ring_all_gather(shards)
    assert launch_counts()["ring_all_gather"] == before + 1
    for out, ref in zip(outs, ring_all_gather_plain(shards)):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.equal(out.view(torch.uint8) if dtype.is_floating_point else out,
                           ref.view(torch.uint8) if dtype.is_floating_point else ref)


def test_ring_repeated_calls_stay_exact(cuda_device):
    """50 calls back to back, the generation rising: a stale flag of an
    earlier call would let a rank forward a chunk before it arrived."""
    for i in range(50):
        shards = ring_shards(8, (32, 512), torch.float32, cuda_device, seed=i)
        for out, ref in zip(launch_ring_all_gather(shards), ring_all_gather_plain(shards)):
            assert torch.equal(out, ref)


def test_ring_protocol_timeout_raises_and_the_ring_recovers(cuda_device):
    shards = ring_shards(4, (32, 512), torch.float32, cuda_device)
    _launch_ring(shards, timeout_ns=20_000_000, drop_step=0)  # queued: the fault shows at the check
    with pytest.raises(RuntimeError, match="protocol timeout"):
        check_ring(cuda_device)
    check_ring(cuda_device)  # reported once
    for out, ref in zip(launch_ring_all_gather(shards), ring_all_gather_plain(shards)):
        assert torch.equal(out, ref)


def test_ring_diff_backward_is_the_reduce_scatter(cuda_device):
    shards = [t.requires_grad_() for t in ring_shards(4, (8, 16), torch.float32, cuda_device)]
    outs = ring_all_gather_diff(shards)
    weights = ring_shards(4, (32, 16), torch.float32, cuda_device, seed=1)
    sum((o * w).sum() for o, w in zip(outs, weights)).backward()
    total = torch.stack(weights).sum(0)
    for r, shard in enumerate(shards):
        torch.testing.assert_close(shard.grad, total[r * 8:(r + 1) * 8], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mmgclip", [False, True])
def test_global_losses_through_the_ring_match_single_device(cuda_device, mmgclip):
    from mmgclip_tpu_torch.losses import clip_loss, mmgclip_loss
    from mmgclip_tpu_torch.models.clip import l2_normalize

    ranks, local, d = 8, 8, 64
    kinds = 3 if mmgclip else 2
    shards = [[l2_normalize(t).requires_grad_() for t in ring_shards(ranks, (local, d), torch.float32,
                                                                      cuda_device, seed=k)]
              for k in range(kinds)]
    scale = torch.tensor(1 / 0.07, device=cuda_device)
    before = launch_counts()["ring_all_gather"]
    if mmgclip:
        loss, _ = global_mmgclip_loss(*shards, scale, use_ring_gather=True)
    else:
        loss, _ = global_clip_loss(*shards, scale, use_ring_gather=True)
    assert launch_counts()["ring_all_gather"] == before + (4 if mmgclip else 2)
    loss.backward()
    full = [torch.cat([t.detach() for t in s]).requires_grad_() for s in shards]
    if mmgclip:
        ref, _ = mmgclip_loss(*full, scale)
    else:
        ref, _ = clip_loss(scale * full[0] @ full[1].T, scale * full[1] @ full[0].T)
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    for s, f in zip(shards, full):
        torch.testing.assert_close(torch.cat([t.grad for t in s]), f.grad, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# the product gates

def test_product_gates_hold_on_the_card(cuda_device, tmp_path):
    """``chip_smoke.py`` phase 15: one checkpoint trained on plain-path
    features; a store per speed knob encoded through its kernels (each
    launched); AUC within 0.005 of the baseline's (best >= 0.9) and the
    reports byte-identical."""
    import chip_smoke

    aucs = chip_smoke.phase_product_gates(cuda_device, str(tmp_path))
    assert set(aucs) == {"baseline", *chip_smoke.GATE_VARIANTS}


# ----------------------------------------------------------------------
# main-path step 4 and the other entry points

def test_report_paths_hold_on_the_card(cuda_device, tmp_path):
    """``chip_smoke.py`` phase 16 over a reduced-width trained run:
    ``generate_report`` for a full-field image and a four-view exam through
    the feature-store preset's kernels (each launched per view), equal to the
    serving engine's decisions and reports; ``evaluate_cnn`` on the card
    against the CPU; the unix-socket server answering as ``handle``."""
    import chip_smoke
    from mmgclip_tpu_torch.train import run

    tree = chip_smoke.write_train_tree(str(tmp_path / "tree"), 40)
    run_dir = str(tmp_path / "run")
    run(chip_smoke.train_config(run_dir, tree, [
        "networks.text_encoder.config={hidden_size: 64, num_hidden_layers: 2, "
        "num_attention_heads: 4, intermediate_size: 128}",
        "dataloader.train.batch_size=8", "dataloader.valid.batch_size=4",
        "dataloader.test.batch_size=4", "scheduler.config.epochs=1"]), device=cuda_device)
    out = chip_smoke.phase_report_paths(cuda_device, str(tmp_path), run_dir, tree)
    assert {"image", "exam", "evaluate_cnn", "serve_ms"} <= set(out["times"])


# ----------------------------------------------------------------------
# the fused epoch as a CUDA graph, and the exam family's encode path

TINY_TEXT = ("networks.text_encoder.config={hidden_size: 64, num_hidden_layers: 2, "
             "num_attention_heads: 4, intermediate_size: 128}")


RESNET_MICRO = ["networks=clip_resnet50_bert", "networks.image_encoder.config={micro: true}"]


def small_config(family, root, name, extra=()):
    """A reduced-width config of a training family, dropout on: ``binary``,
    ``resnet`` (the binary family with the micro ResNet tower, whose
    ``layer4`` trains) or ``exam``."""
    import chip_smoke

    run_dir = str(root / name)
    if family in ("binary", "resnet"):
        tree = chip_smoke.write_train_tree(str(root / f"{name}_tree"), 24)
        return chip_smoke.train_config(run_dir, tree, [
            TINY_TEXT, "dataloader.train.batch_size=8", "dataloader.valid.batch_size=4",
            "dataloader.test.batch_size=4", *(RESNET_MICRO if family == "resnet" else []), *extra])
    reports_csv, gtr_csv = chip_smoke.write_exam_training(str(root / f"{name}_data"), [], 64)
    return chip_smoke.exam_config(run_dir, reports_csv, gtr_csv, [
        TINY_TEXT, "loss=mmgclip", "dataloader.train.batch_size=8", "dataloader.valid.batch_size=4",
        *extra])


@pytest.mark.parametrize("family", ["binary", "exam", "resnet"])
def test_graphed_epoch_matches_the_eager_epoch(cuda_device, tmp_path, family):
    """``chip_smoke.graph_vs_eager``: two epochs graphed (the first with its
    eager warm-up steps and the capture) against two eager epochs from the
    same seeded state, dropout on: losses and params within 1e-6 relative.
    With the ResNet the captured step holds the tower's forward and the
    ``layer4`` backward (the bottlenecks recomputed under ``remat``); both
    runs pin cuDNN's deterministic algorithms, whose default weight-gradient
    algorithms sum in an order that varies between runs."""
    import chip_smoke

    out = chip_smoke.graph_vs_eager(cuda_device, small_config(family, tmp_path, "run"), family)
    assert len(out["graph_ms"]) == len(out["eager_ms"]) == 2


def test_resume_after_capture_matches_an_unbroken_run(cuda_device, tmp_path):
    """A run stopped after two epochs (its graph captured), its live state
    scrambled, then ``resume()`` from its best checkpoint: the later epochs
    replay the same graph against the restored tensors and end where an
    unbroken run ends (losses and params within 1e-6 relative; dropout on,
    the dropout key restored from the checkpoint)."""
    resume_after_capture(cuda_device, tmp_path, "binary")


def test_resnet_resume_after_capture_matches_an_unbroken_run(cuda_device, tmp_path):
    """The same with the micro ResNet tower: the masked optimizer chain is
    restored in place into the moments the captured step reads, and the
    frozen stages keep no gradient.  Both runs pin cuDNN's deterministic
    algorithms (see ``test_graphed_epoch_matches_the_eager_epoch``)."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        broken = resume_after_capture(cuda_device, tmp_path, "resnet")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    frozen = [p for p in broken.params.values() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)


def resume_after_capture(cuda_device, tmp_path, family):
    from mmgclip_tpu_torch.train import build_experiment
    from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
    from mmgclip_tpu_torch.utils.tb import ScalarWriter, read_scalars
    from mmgclip_tpu_torch.weights import clip_params_tree, flatten_tree

    extra = ["dataloader.valid.shuffle=false"]
    straight_cfg = small_config(family, tmp_path, "straight", extra)
    straight = build_experiment(straight_cfg, device=cuda_device)
    straight.run()

    cfg = small_config(family, tmp_path, "broken", extra)
    broken = build_experiment(cfg, device=cuda_device)
    cfg.scheduler.config.epochs = 2  # stop early; the schedule keeps its 3-epoch total
    broken.run()
    graph = broken._graph
    best = load_checkpoint(broken.ckp_path)["epoch"]
    assert graph is not None and best in (0, 1)
    with torch.no_grad():
        for p in broken.params.values():
            p.add_(1.0)
        for slot in (broken.optimizer.mu, broken.optimizer.nu):
            for t in slot.values():
                t.zero_()
        broken.optimizer.count.fill_(0)
        broken.optimizer.hyperparams["weight_decay"].fill_(0.5)
    broken.rng_key.fill_(123)
    cfg.scheduler.config.epochs = 3
    assert broken.resume() and broken.current_epoch == best + 1
    broken.writer = ScalarWriter(cfg.base.tensorboard_export_dir)  # run() closed it
    broken.run()
    assert broken._graph is graph  # no second capture: the old graph saw the restored state
    want = read_scalars(straight_cfg.base.tensorboard_export_dir)
    got = read_scalars(cfg.base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        np.testing.assert_allclose(got[tag], want[tag], rtol=1e-6, err_msg=tag)
    ours, theirs = (flatten_tree(clip_params_tree(e.model)) for e in (broken, straight))
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-6, atol=1e-7, err_msg=key)
    return broken


def test_resnet_tower_on_the_card_matches_the_cpu(cuda_device):
    """The micro ResNet (seeded, running statistics moved off 0 / 1) on the
    card against the CPU, fp32 with TF32 off: forward features and the
    ``layer4`` gradients within 1e-5 relative L2, the frozen stages without
    gradients."""
    from mmgclip_tpu_torch.models.resnet import ResNet50Encoder, ResNetConfig

    cpu = ResNet50Encoder(ResNetConfig.micro(), torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, buffer in cpu.named_buffers():
            low, high = (0.5, 1.5) if name.endswith("var") else (-0.3, 0.3)
            buffer.copy_(torch.from_numpy(rng.uniform(low, high, buffer.shape).astype(np.float32)))
    for name, p in cpu.named_parameters():
        p.requires_grad_(name.startswith("layer4"))
    card = ResNet50Encoder(ResNetConfig.micro())
    card.load_state_dict(cpu.state_dict())
    for name, p in card.named_parameters():
        p.requires_grad_(name.startswith("layer4"))
    card.to(cuda_device)
    for width in (768, 37):
        x = torch.from_numpy(rng.standard_normal((6, width)).astype(np.float32))
        outs = []
        for tower, dev in ((cpu, "cpu"), (card, cuda_device)):
            tower.zero_grad(set_to_none=True)
            y = tower(x.to(dev))
            y.square().sum().backward()
            outs.append((y.detach().cpu(), {k: None if p.grad is None else p.grad.cpu()
                                            for k, p in tower.named_parameters()}))
        (want, want_grads), (got, got_grads) = outs
        assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5
        for key, grad in want_grads.items():
            assert (grad is None) == (got_grads[key] is None) == (not key.startswith("layer4")), key
            if grad is not None:
                assert float(torch.linalg.norm(got_grads[key] - grad) / torch.linalg.norm(grad)) <= 1e-5, key


def test_encode_studies_launches_the_store_kernels(cuda_device, tmp_path):
    """``chip_smoke.exam_encode`` at a small size with ConvNeXt-Tiny in the
    feature-store preset: 22 launches (1 stem, 3 downsamples, 18 int8
    blocks) per program call, one call per view shape; the corrupt study in
    ``failed.txt``; the study vectors against the engine's views and the
    plain tower."""
    import chip_smoke

    table, vectors, times = chip_smoke.exam_encode(
        cuda_device, str(tmp_path / "exam"), "card test", ((256, 208), (250, 200)),
        chip_smoke.REPORT_TOWER, [TINY_TEXT], 2)
    assert len(table) == 2 and vectors.shape == (2, 768) and times["encode_s"] > 0


# ----------------------------------------------------------------------
# threefry and dropout (port-only kernel, csrc/threefry_dropout.cu)

@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_threefry_kernel_matches_plain(cuda_device, seed):
    key = prng.key(seed)
    for n in (1, 2, 3, 257, 100_003):
        assert torch.equal(device_split(key.to(cuda_device), n).cpu(), prng.split(key, n))
    for data in (0, 1, 0x9E3779B9, 2**32 - 1):
        assert torch.equal(device_fold_in(key.to(cuda_device), data).cpu(), prng.fold_in(key, data))


@pytest.mark.parametrize("shape", [(64, 768), (4096, 4096), (7, 13), (1,), (3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_kernel_matches_plain(cuda_device, shape, dtype, rate):
    """Mask, output and gradient bit-equal to the plain version on the CPU."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    key, fold = prng.split(prng.key(11), 3)[1], prng.make_rng_constant(["Dropout_0"])
    out, mask = launch_dropout(x.to(cuda_device), key.to(cuda_device), fold, 1.0 - rate)
    ref, ref_mask = plain_dropout(x, key, fold, 1.0 - rate)
    assert torch.equal(mask.cpu().bool(), ref_mask)
    assert torch.equal(out.cpu(), ref)
    xc, xg = x.clone().requires_grad_(True), x.to(cuda_device).requires_grad_(True)
    dropout(xc, key, fold, rate).backward(g)
    dropout(xg, key.to(cuda_device), fold, rate).backward(g.to(cuda_device))
    assert torch.equal(xg.grad.cpu(), xc.grad)


def test_dropout_key_advances_inside_a_cuda_graph(cuda_device):
    """A step that splits its key in place and draws a mask, captured once
    and replayed, draws what the eager steps draw (no host read)."""
    x = torch.randn(64, 768, device=cuda_device)
    fold = prng.make_rng_constant(["Dropout_0"])

    def step(key, out):
        keys = device_split(key, 2)
        key.copy_(keys[0])
        out.copy_(dropout(x, device_split(keys[1], 3)[0], fold, 0.2))

    eager_key, eager_out = prng.key(5).to(cuda_device), torch.empty_like(x)
    eager = []
    for _ in range(4):
        step(eager_key, eager_out)
        eager.append(eager_out.clone())
    key, out = prng.key(5).to(cuda_device), torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(key, out)  # warm-up: the first eager step
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # records the step; runs nothing
        step(key, out)
    for want in eager[1:]:
        graph.replay()
        assert torch.equal(out, want)
    assert torch.equal(key, eager_key)


def test_tsne_on_the_card_matches_the_cpu(cuda_device):
    """The t-SNE's sums run in another order on the card, and its
    iterations amplify that, so the two runs are held by the objective:
    KL within 1% relative, trustworthiness within 0.01."""
    from chip_smoke import trustworthiness, tsne_clusters
    from mmgclip_tpu_torch.utils.tsne import tsne

    x = tsne_clusters(300, seed=3)
    card, cpu = tsne(x, device=cuda_device), tsne(x, device="cpu")
    assert abs(card.kl_divergence - cpu.kl_divergence) <= 0.01 * cpu.kl_divergence
    assert abs(trustworthiness(x, card.embedding) - trustworthiness(x, cpu.embedding)) <= 0.01


def test_convert_convnext_verifies_on_the_card(cuda_device, tmp_path):
    from mmgclip_tpu_torch.tools import convert_convnext
    from mmgclip_tpu_torch.tools.fixtures import TorchvisionConvNeXt, write_torchscript

    scripted = str(tmp_path / "classifier.pt")
    write_torchscript(TorchvisionConvNeXt(in_channels=1, seed=0), scripted, torch.zeros(1, 1, 64, 64))
    card = convert_convnext.main(["--input", scripted, "--output", str(tmp_path / "card.npz"),
                                  "--verify"])
    assert card["max_abs_err"] <= 1e-4
    convert_convnext.main(["--input", scripted, "--output", str(tmp_path / "cpu.npz"),
                           "--device", "cpu"])
    assert (tmp_path / "card.npz").read_bytes() == (tmp_path / "cpu.npz").read_bytes()


def test_text_converters_write_the_same_bytes_on_the_card(cuda_device, tmp_path):
    from mmgclip_tpu_torch.tools import convert_bert, convert_biogpt
    from mmgclip_tpu_torch.tools.fixtures import bert_state_dict, write_hf_snapshot

    bert = {"vocab_size": 120, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 128, "max_position_embeddings": 64}
    snapshot = write_hf_snapshot(str(tmp_path / "bert"), bert, bert_state_dict(bert), "safetensors")
    for device, name in ((None, "card"), ("cpu", "cpu")):
        convert_bert.main(["--input", snapshot, "--output", str(tmp_path / f"bert_{name}.msgpack")]
                          + (["--device", device] if device else []))
    assert (tmp_path / "bert_card.msgpack").read_bytes() == (tmp_path / "bert_cpu.msgpack").read_bytes()

    g = torch.Generator().manual_seed(0)
    gpt = {"vocab_size": 80, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64, "max_position_embeddings": 48}
    h, i = gpt["hidden_size"], gpt["intermediate_size"]
    state = {"biogpt.embed_tokens.weight": torch.randn(80, h, generator=g),
             "biogpt.embed_positions.weight": torch.randn(50, h, generator=g),
             "biogpt.layer_norm.weight": torch.randn(h, generator=g),
             "biogpt.layer_norm.bias": torch.randn(h, generator=g)}
    for layer in range(2):
        pre = f"biogpt.layers.{layer}."
        for name, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (h, h)),
                            ("self_attn.v_proj", (h, h)), ("self_attn.out_proj", (h, h)),
                            ("fc1", (i, h)), ("fc2", (h, i))):
            state[pre + name + ".weight"] = torch.randn(*shape, generator=g)
            state[pre + name + ".bias"] = torch.randn(shape[0], generator=g)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            state[pre + name + ".weight"] = torch.randn(h, generator=g)
            state[pre + name + ".bias"] = torch.randn(h, generator=g)
    snapshot = write_hf_snapshot(str(tmp_path / "gpt"), gpt, state, "bin")
    for device, name in ((None, "card"), ("cpu", "cpu")):
        convert_biogpt.main(["--input", snapshot, "--output", str(tmp_path / f"gpt_{name}.msgpack")]
                            + (["--device", device] if device else []))
    assert (tmp_path / "gpt_card.msgpack").read_bytes() == (tmp_path / "gpt_cpu.msgpack").read_bytes()


# ----------------------------------------------------------------------
# the ring across processes (gloo ranks sharing the card)
# ----------------------------------------------------------------------

_PEER_CHILD = r'''
import json, os, sys, time
import numpy as np, torch
from mmgclip_tpu_torch.parallel import collectives as C
from mmgclip_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh
from mmgclip_tpu_torch.parallel.multihost import initialize_distributed, shutdown

rank, world, store, case = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize_distributed(store, world, rank, backend="gloo")
device = torch.device("cuda", torch.cuda.current_device())
mesh = create_mesh(data=world)
rng = np.random.default_rng(0)
shards = [torch.from_numpy(rng.standard_normal((8, 96)).astype(np.float32)).to(device)
          for _ in range(world)]
report = {}
if case == "gather":
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    for call in range(3):  # both buffers of the workspace, then the first again
        for dtype in (torch.float32, torch.bfloat16):
            x = [s.to(dtype) for s in shards]
            reset_launch_counts()
            out = C.ring_all_gather(x[rank], DATA_AXIS, mesh=mesh)
            assert launch_counts()["ring_all_gather"] == 1, (call, dtype)
            assert torch.equal(out.view(torch.uint8), torch.cat(x).view(torch.uint8)), (call, dtype)
    ragged = [s[:3, :5].contiguous() for s in shards]  # 60-byte chunks: byte-wide copies
    assert torch.equal(C.ring_all_gather(ragged[rank], DATA_AXIS, mesh=mesh), torch.cat(ragged))
    report["workspaces"] = len(C._WORKSPACES)
    C.release_workspaces()
    report["after_release"] = len(C._WORKSPACES)
elif case == "withhold":
    C.PEER_TIMEOUT_S = 1.0
    t0 = time.perf_counter()
    try:
        C._peer_ring(shards[rank], mesh, DATA_AXIS, withhold=rank == 1)
        C.check_ring(device)
        report["raised"] = ""
    except RuntimeError as exc:
        report["raised"] = str(exc)
    report["seconds"] = time.perf_counter() - t0
    torch.distributed.barrier()
    out = C.ring_all_gather(shards[rank], DATA_AXIS, mesh=mesh)
    report["recovered"] = bool(torch.equal(out, torch.cat(shards)))
elif case == "dead":
    C.PEER_TIMEOUT_S = 2.0
    C.ring_all_gather(shards[rank], DATA_AXIS, mesh=mesh)  # both map the workspaces
    if rank == 1:
        os._exit(0)  # a rank that dies without a word
    try:
        C.ring_all_gather(shards[rank], DATA_AXIS, mesh=mesh)
        report["raised"] = ""
    except RuntimeError as exc:
        report["raised"] = str(exc)
    print("report=" + json.dumps(report), flush=True)
    os._exit(0)
print("report=" + json.dumps(report), flush=True)
shutdown()
'''


def run_peer_children(tmp_path, world, case, timeout=180):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = "file://" + str(tmp_path / f"pg_{case}")
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _PEER_CHILD, str(r), str(world), store, case],
                              cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    reports = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, out[-3000:]
            lines = [line for line in out.splitlines() if line.startswith("report=")]
            reports.append(json.loads(lines[-1][len("report="):]) if lines else None)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return reports


@pytest.mark.parametrize("world", [2, 4])
def test_peer_ring_is_bit_equal_to_cat_and_tears_down(cuda_device, tmp_path, world):
    """Repeated calls in fp32 and bf16, a ragged shard; one workspace for the
    size class (every shard here fits the smallest), mapped by every peer,
    closed and freed by ``release_workspaces``."""
    reports = run_peer_children(tmp_path, world, "gather")
    assert all(r["workspaces"] == 1 and r["after_release"] == 0 for r in reports), reports


def test_peer_ring_withheld_signal_raises_and_recovers(cuda_device, tmp_path):
    reports = run_peer_children(tmp_path, 2, "withhold")
    assert "protocol timeout across processes" in reports[0]["raised"], reports
    assert reports[1]["raised"] == "" and 0.9 < reports[0]["seconds"] < 30, reports
    assert all(r["recovered"] for r in reports), reports


def test_peer_ring_raises_when_a_rank_dies(cuda_device, tmp_path):
    reports = run_peer_children(tmp_path, 2, "dead")
    assert "protocol timeout across processes" in reports[0]["raised"], reports
