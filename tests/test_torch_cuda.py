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
deadline instead of hanging; the encoder's ``encode.device`` spans under a
profiler, one per batch and replica, in submit order inside the pass, and
no ``DeviceClock`` built by an untraced ``extract()`` or bank encode; the
PNG unfilter kernel bit-equal to the host unfilter (``csrc/png_unfilter.c``
and the reader's byte swap) for every filter type, forced and mixed per row,
at 8 and 16 bits, odd widths, one-pixel rows, saturated rows, zero pad
images and a batch of 32 of the benchmark's full-field phantoms, and
``extract()`` writing the same ``.npy`` bytes through it as through the host
decode; the causal latent-attention kernel against its plain version within
two bf16 steps of the largest output (both round P to bf16, at different
points, after float32 sums taken in another order), its rotated operands
bit-equal to ``rope_pairs``, a second launch bit-equal, and its NoPE path
(no tables) within the same bounds; the KDA scan kernel against its chunked
plain version within two bf16 steps of the largest output and 1e-2 relative
L2 a row (both sum in float32 and round the output once), zeros past each
row's length, a second launch bit-equal, and its planted-fault variants as
the plain path computes them; the grouped expert kernel over a held range of
128 of 256 experts; the tiny Kimi-Linear tower's bank through the kernels,
with its spans; the RMSNorm kernel against its plain version, every bf16
element within one bf16 step and float32 outputs within 1e-6 of the
largest, gated, strided and ragged, a second launch bit-equal, and the
towers launching it once a norm.
"""

import os

import numpy as np
import pytest
import torch

from mmgclip_tpu_torch.models.deepseek_v3 import rope_tables
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
from mmgclip_tpu_torch.ops.mla_attention import (
    launch_mla_attention,
    mla_attention,
    plain_mla_attention,
    rope_pairs,
)
from mmgclip_tpu_torch.ops.moe_experts import dispatch, launch_moe_experts, plain_moe_experts
from mmgclip_tpu_torch.ops.png_unfilter import launch_png_unfilter, png_unfilter
from mmgclip_tpu_torch.ops.rms_norm import launch_rms_norm, plain_rms_norm, rms_norm
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
        "png_unfilter": lambda: launch_png_unfilter(torch.zeros(1, 2, 5, dtype=torch.uint8), 16),
        "mla_attention": lambda: launch_mla_attention(
            torch.zeros(1, 4, 4 * 24, dtype=torch.bfloat16), torch.zeros(1, 4, 8, dtype=torch.bfloat16),
            torch.zeros(1, 4, 4 * 32, dtype=torch.bfloat16), *rope_tables(4, 8, 50000.0, "cpu"),
            torch.ones(1, 4, dtype=torch.bool), 4),
        "moe_experts": lambda: launch_moe_experts(
            torch.zeros(4, 16, dtype=torch.bfloat16), dispatch(torch.zeros(4, 2, dtype=torch.long), 2),
            torch.ones(4, 2), torch.zeros(2, 16, 16, dtype=torch.bfloat16),
            torch.zeros(2, 16, 8, dtype=torch.bfloat16)),
        "rms_norm": lambda: launch_rms_norm(torch.zeros(4, 16, dtype=torch.bfloat16),
                                            torch.ones(16, dtype=torch.bfloat16), 1e-5),
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


# ----------------------------------------------------------------------
# the feature-store encode over several devices, StepTimer


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")])
def test_encoder_over_devices_is_bit_equal_to_one_card(cuda_device, tmp_path, devices):
    """``_Encoder`` in the store preset (int8 blocks, fused stem and
    downsample) with two replicas, on one card or on two, against one
    device: every vector bit-equal, each replica launching the store
    kernels once per shard.  Two cards also show the launch on a card other
    than card 0 (each launch sets its kernel's shared-memory limit on the
    current card)."""
    import chip_smoke
    from mmgclip_tpu_torch.ingest.encode import _Encoder
    from mmgclip_tpu_torch.ops import reset_launch_counts

    if torch.cuda.device_count() < len(set(devices)):
        pytest.skip(f"needs {len(set(devices))} CUDA cards")
    items = []
    for i, (h, w) in enumerate([(256, 208)] * 3 + [(250, 200)] * 2):
        path = str(tmp_path / f"view_{i}.png")
        chip_smoke.write_png16(path, chip_smoke.synthetic_mammogram(h, w, seed=i))
        items.append((path, path))
    cfg = chip_smoke.store_config(str(tmp_path), ("", "", ""), str(tmp_path / "store"))
    feats, counts = {}, {}
    for devs in (("cuda:0",), devices):
        encoder = _Encoder(cfg, batch_size=4, device=list(devs))
        chip_smoke.set_layer_scale(encoder.module, 0.1)
        out = {}
        reset_launch_counts()
        encoder.encode_batches(items, out.__setitem__, str(tmp_path / "failed.txt"))
        feats[devs], counts[devs] = out, launch_counts()
    one, two = feats[("cuda:0",)], feats[devices]
    assert sorted(one) == sorted(two) == sorted(p for p, _k in items)
    for key, vec in one.items():
        assert vec.shape == (768,) and np.isfinite(vec).all()
        assert np.array_equal(two[key], vec), key
    # one card: 2 buckets, one batch each; two replicas: a launch per shard
    assert counts[("cuda:0",)]["fused_convnext_block_int8"] == 18 * 2
    assert counts[devices]["fused_convnext_block_int8"] == 18 * 2 * 2
    assert counts[devices]["fused_stem"] == 2 * 2 and counts[devices]["fused_ln_downsample"] == 3 * 2 * 2


def test_step_timer_waits_for_the_card(cuda_device):
    from mmgclip_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer()
    x = torch.ones(8, device=cuda_device)
    timer.start()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    done = torch.cuda.Event()
    done.record()
    elapsed = timer.stop({"step": [x * 2]})
    assert done.query() and elapsed >= 0.02 and timer.times == [elapsed]


@pytest.mark.parametrize("devices", [("cuda:0",), ("cuda:0", "cuda:0")])
def test_encoder_device_spans_follow_the_batches(cuda_device, tmp_path, devices):
    """Under a profiler session ``_Encoder.encode_batches`` records one
    ``encode.device`` span per batch and replica, inside its ``encode.pass``,
    in submit order on the card's one stream (each starts where the one
    before it has ended), their busy time at most the pass."""
    import chip_smoke
    from mmgclip_tpu_torch.ingest.encode import _Encoder
    from mmgclip_tpu_torch.utils import profiling

    items = []
    for i, (h, w) in enumerate([(256, 208)] * 3 + [(250, 200)] * 2):
        path = str(tmp_path / f"view_{i}.png")
        chip_smoke.write_png16(path, chip_smoke.synthetic_mammogram(h, w, seed=i))
        items.append((path, path))
    cfg = chip_smoke.store_config(str(tmp_path), ("", "", ""), str(tmp_path / "store"))
    encoder = _Encoder(cfg, batch_size=2, device=list(devices))
    chip_smoke.set_layer_scale(encoder.module, 0.1)
    failed = str(tmp_path / "failed.txt")
    encoder.encode_batches(items, {}.__setitem__, failed)  # builds and warms the kernels
    profiling.reset_spans()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=activities):
            encoder.encode_batches(items, {}.__setitem__, failed)
        records = profiling.spans()
    finally:
        profiling.reset_spans()
    (root,) = [r for r in records if r["name"] == "encode.pass"]
    spans = [r for r in records if r["name"] == "encode.device"]
    batches = root["attrs"]["batches"]
    assert batches == 3  # 2 + 2 rows of two shapes, then the one left
    assert [r["attrs"]["batch"] for r in spans] == [b for b in range(batches)
                                                    for _ in devices]
    assert all(r["parent"] == root["id"] and r["thread"] == "cuda:0" for r in spans)
    assert all(r["attrs"].keys() == {"batch"} for r in spans)
    for before, after in zip(spans, spans[1:]):
        assert before["start_ns"] <= before["end_ns"] <= after["start_ns"] <= after["end_ns"]
    assert root["start_ns"] <= spans[0]["start_ns"] and spans[-1]["end_ns"] <= root["end_ns"]
    busy = sum(r["end_ns"] - r["start_ns"] for r in spans)
    assert 0 < busy <= root["end_ns"] - root["start_ns"]


# ----------------------------------------------------------------------
# the PNG unfilter

# (h, w): one band and one chunk; a band past 32 rows; chunks that end
# mid-block and on a block; 600 rows, so warps take a second band
UNFILTER_SHAPES = [(9, 7), (37, 29), (40, 33), (33, 34), (70, 64), (35, 65), (45, 131), (600, 75)]


def unfilter_case(rng, h, w, bpp, kinds):
    """Random raw rows (row 2 saturated, row 3 zero) filtered with ``kinds``."""
    import chip_smoke

    raw = rng.integers(0, 256, size=(h, w * bpp), dtype=np.uint8)
    raw[2 % h] = 255
    raw[3 % h] = 0
    return chip_smoke.filter_rows(raw, bpp, kinds)


def assert_unfilter_matches_host(rows: np.ndarray, depth: int, device):
    import chip_smoke

    before = launch_counts()["png_unfilter"]
    got = png_unfilter(torch.from_numpy(rows).to(device), depth)
    assert launch_counts()["png_unfilter"] == before + 1
    assert got.dtype == (torch.uint16 if depth == 16 else torch.uint8)
    got = got.cpu().numpy()
    assert got.shape == (rows.shape[0], rows.shape[1], (rows.shape[2] - 1) // (depth // 8))
    for i, image in enumerate(rows):
        np.testing.assert_array_equal(got[i], chip_smoke.host_unfilter(image, depth), err_msg=str(i))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_png_unfilter_kernel_matches_the_host(cuda_device, kind, depth):
    rng = np.random.default_rng(depth + (9 if kind == "mixed" else kind))
    for h, w in UNFILTER_SHAPES:
        rows = np.stack([unfilter_case(rng, h, w, depth // 8, rng.integers(0, 5, h)
                                       if kind == "mixed" else np.full(h, kind))
                         for _ in range(3)])
        assert_unfilter_matches_host(rows, depth, cuda_device)


@pytest.mark.parametrize("depth", [8, 16])
def test_png_unfilter_kernel_on_one_pixel_rows_and_pad_images(cuda_device, depth):
    """Rows one pixel wide (no byte has a left neighbour), and a batch whose
    last images are zero rows (the encoder's pad): zeros."""
    rng = np.random.default_rng(depth)
    rows = np.stack([unfilter_case(rng, 50, 1, depth // 8, rng.integers(0, 5, 50))
                     for _ in range(2)])
    assert_unfilter_matches_host(rows, depth, cuda_device)
    rows = np.stack([unfilter_case(rng, 40, 66, depth // 8, rng.integers(0, 5, 40)),
                     np.zeros((40, 1 + 66 * depth // 8), np.uint8),
                     np.zeros((40, 1 + 66 * depth // 8), np.uint8)])
    out = png_unfilter(torch.from_numpy(rows).to(cuda_device), depth).cpu().numpy()
    assert not out[1:].any()
    assert_unfilter_matches_host(rows, depth, cuda_device)


def test_png_unfilter_kernel_on_a_batch_of_full_field_phantoms(cuda_device):
    """32 of the store benchmark's 2294 x 1914 12-bit phantoms, every row
    Paeth, as its PNG files hold them: bit-equal to the host."""
    import chip_smoke
    from portbench.data.phantom import phantom

    rows = np.stack([chip_smoke.filter_rows(
        phantom(2147484001, i, 2294, 1914).astype(">u2").view(np.uint8), 2, np.full(2294, 4))
        for i in range(32)])
    assert_unfilter_matches_host(rows, 16, cuda_device)


def test_extract_writes_the_same_store_through_the_card_unfilter(cuda_device, tmp_path,
                                                                 monkeypatch):
    """``extract()`` over a few 16-bit phantoms (Paeth and unfiltered files,
    two shapes): the card unfilters every batch, and each ``.npy`` file's
    bytes equal those of the host decode's store."""
    import chip_smoke
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.ops import reset_launch_counts

    rows = []
    for i, (h, w) in enumerate([(256, 208)] * 3 + [(250, 200)] * 2):
        path = str(tmp_path / "2D_100micron" / f"view_{i}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        chip_smoke.write_png16(path, chip_smoke.synthetic_mammogram(h, w, seed=i), paeth=i % 2 == 0)
        rows.append({"image_path": path})
    cfg = chip_smoke.store_config(str(tmp_path), ("", "", ""), str(tmp_path / "store"))
    stores, counts = {}, {}
    for route in ("card", "host"):
        if route == "host":
            monkeypatch.setattr(ImageFeatureExtractor, "_unfilters_on_card", lambda self: False)
        ex = ImageFeatureExtractor(cfg, dataset=rows, batch_size=2, device=cuda_device)
        chip_smoke.set_layer_scale(ex.module, 0.1)
        ex.export_dir = str(tmp_path / f"store_{route}")
        reset_launch_counts()
        assert ex.extract() == len(rows)
        counts[route] = launch_counts()["png_unfilter"]
        stores[route] = {r["image_path"]: open(ex._export_path(r["image_path"]), "rb").read()
                         for r in rows}
    assert counts == {"card": 3, "host": 0}  # 2 + 1 of one shape, 2 of the other
    assert stores["card"] == stores["host"]


# ----------------------------------------------------------------------
# the grouped expert kernel (csrc/moe_experts.cu)
# ----------------------------------------------------------------------
# one expert takes 30,000 of 32,768 rows: 1,044 tiles of uneven expert shares
# over the 132 persistent CTAs
SKEWED_COUNTS = [30000, 0] + [212] * 12 + [0, 224]
# an expert of one row and counts at 128 j - 1, 128 j and 128 j + 1
EDGE_COUNTS = [1, 0, 127, 128, 129, 255, 256, 257, 383, 384, 385, 1, 2, 3, 0, 289]


@pytest.mark.parametrize("tokens,d_model,width,experts,k,counts", [
    (131072, 2048, 1408, 64, 6, None),  # one chunk of Moonlight-16B-A3B's bank encode
    (333, 72, 40, 8, 2, None),          # ragged tiles, K past one 64-wide step, N past one tile
    (8192, 1024, 512, 16, 4, SKEWED_COUNTS),
    (1300, 320, 192, 16, 2, EDGE_COUNTS),
    (4099, 200, 136, 16, 4, None),      # N past 128 (half a gate|up tile), K past 192
], ids=["moonlight", "ragged", "skewed", "edges", "narrow"])
def test_moe_experts_kernel_matches_plain(cuda_device, tokens, d_model, width, experts, k, counts):
    """Uneven counts with two experts given no token; the kernel's weighted
    sum against its plain version within two bf16 steps of the largest
    value (the SwiGLU and each weighted row are rounded to bf16 on both
    sides, after float32 sums taken in another order), and a second launch
    bit-equal to the first."""
    import chip_smoke

    x, plan, weights, w_gate_up, w_down = chip_smoke.moe_layer_inputs(
        cuda_device, tokens, d_model, width, experts, k, empty=(1, experts - 2), counts=counts)
    assert plan.counts[1] == 0 and plan.counts[experts - 2] == 0
    if counts is not None:
        assert plan.counts.tolist() == counts
    before = launch_counts()["moe_experts"]
    got = launch_moe_experts(x, plan, weights, w_gate_up, w_down)
    assert launch_counts()["moe_experts"] == before + 1
    want = plain_moe_experts(x, plan, weights, w_gate_up, w_down)
    assert float((got - want).abs().max() / want.abs().max()) <= BF16_REL_TOL
    assert torch.equal(launch_moe_experts(x, plan, weights, w_gate_up, w_down), got)


def test_moe_experts_kernel_replays_in_a_cuda_graph(cuda_device):
    """A call captured in a CUDA graph, then replayed after new activations,
    routing and weights are copied into the captured tensors, gives the bits
    of an eager launch on those inputs: the kernel reads its tile count and
    offsets on the device, and its tensor maps name the captured buffers."""
    import chip_smoke

    shape = (2048, 256, 136, 16, 4)
    x, plan, weights, w_gate_up, w_down = chip_smoke.moe_layer_inputs(
        cuda_device, *shape, empty=(1, 14), seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch_moe_experts(x, plan, weights, w_gate_up, w_down)  # builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch_moe_experts(x, plan, weights, w_gate_up, w_down)
    for seed, empty in ((4, (2, 9)), (5, (0, 15))):
        fresh = chip_smoke.moe_layer_inputs(cuda_device, *shape, empty=empty, seed=seed)
        for static, new in zip((x, weights, w_gate_up, w_down), fresh[:1] + fresh[2:]):
            static.copy_(new)
        for name in ("order", "tokens", "offsets", "tile_offsets", "counts"):
            getattr(plan, name).copy_(getattr(fresh[1], name))
        graph.replay()
        assert torch.equal(out, launch_moe_experts(*fresh))


def _moe_trainer(device, tmp_path):
    """The tiny DeepSeek-V3 tower's trainer on the card, and a loader of 48
    fresh rows by seed (its first sweep: seed 0)."""
    from mmgclip_tpu_torch.cli import DEFAULT_CONFIG_DIR
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment
    from torch_deepseek_v3 import tiny_override

    class Rows:
        def __init__(self, seed):
            rng = np.random.default_rng(seed)
            lengths = rng.integers(1, 30, 48)
            mask = (np.arange(64)[None] < lengths[:, None]).astype(np.int32)
            self._tokens = {"input_ids": rng.integers(0, 256, (48, 64)).astype(np.int32) * mask,
                            "attention_mask": mask}
            self._features = rng.normal(size=(48, 768)).astype(np.float32)

        def __len__(self):
            return 48

    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf",
                  ["networks=clip_convnext_moonlight_text", "projection=2xLinear512",
                   tiny_override(), "dataloader.train.batch_size=8",
                   "base.seed=3"], run_dir=str(tmp_path))
    cfg.base.tensorboard_export_dir = str(tmp_path / "tb")

    def loader(seed):
        return DataLoader(Rows(seed), batch_size=8, drop_last=True)

    return ClassifierExperiment(config=cfg, train_dataloader=loader(0), device=device), loader


def _moe_sweeps(device, tmp_path, graphed: bool, sweeps: int = 3):
    """``_moe_trainer``'s ``sweeps`` sweeps of fresh rows through
    ``set_train_data``: -> (each sweep's epoch loss, the heads' parameters
    after the last)."""
    exp, loader = _moe_trainer(device, tmp_path)
    exp.use_cuda_graph = graphed
    losses = [exp.train()]
    for sweep in range(1, sweeps):
        exp.set_train_data(loader(sweep))
        exp.current_epoch += 1
        losses.append(exp.train())
    assert (exp._graph is not None) == graphed
    return losses, {k: v.detach().cpu() for k, v in exp.params.items()}


def test_graphed_sweeps_read_each_new_bank(cuda_device, tmp_path):
    """Sweeps of new rows through ``set_train_data`` on a DeepSeek-V3 tower
    (the grouped expert kernel in every bank): the captured step reads each
    sweep's bank, copied into the tensors it was captured on, so graphed
    sweeps end where eager ones do (losses and heads within 1e-6 relative;
    dropout on)."""
    before = launch_counts()["moe_experts"]
    graphed, g_params = _moe_sweeps(cuda_device, tmp_path / "g", True)
    assert launch_counts()["moe_experts"] - before == 3 * 2  # sweeps x MoE layers, one chunk each
    eager, e_params = _moe_sweeps(cuda_device, tmp_path / "e", False)
    np.testing.assert_allclose(graphed, eager, rtol=1e-6)
    assert len(set(graphed)) == 3
    for name in g_params:
        torch.testing.assert_close(g_params[name], e_params[name], rtol=1e-6, atol=1e-7)


def test_the_tower_records_its_moe_spans_under_each_bank_chunk(cuda_device, tmp_path):
    """Under a profiler session the DeepSeek-V3 tower records, inside each
    ``bank.chunk`` of ``_pool_tokens``, one ``moe.route`` and one
    ``moe.experts`` interval per MoE layer (routing before experts, both
    inside the chunk's ``bank.device``) and one ``moe.tokens_per_expert``
    counter whose counts add up to the chunk's computed tokens times top-k."""
    from mmgclip_tpu_torch.utils import profiling
    from torch_deepseek_v3 import TINY

    exp, loader = _moe_trainer(cuda_device, tmp_path)
    tokens = {k: np.concatenate([v] * 6) for k, v in loader(1).dataset._tokens.items()}  # 288 rows
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            exp._pool_tokens(tokens)
        records = profiling.spans()
    finally:
        profiling.reset_spans()
    chunks = [r for r in records if r["name"] == "bank.chunk"]
    assert [c["attrs"]["rows"] for c in chunks] == [256, 32]
    assert {r["name"] for r in records} == {"bank.encode", "bank.chunk", "bank.device", "moe.route",
                                            "moe.experts", "moe.tokens_per_expert"}
    keys = {"bank.device": set(), "moe.route": {"layer"}, "moe.experts": {"layer"},
            "moe.tokens_per_expert": {"counts"}}
    for r in records:
        if r["name"] in keys:
            assert r["attrs"].keys() == keys[r["name"]], r["name"]
            # the bank's device as the trainer names it; the tower's as its tensors do
            assert r["thread"] == (str(exp.device) if r["name"] == "bank.device" else "cuda:0")
    moe_layers = TINY.num_hidden_layers - TINY.first_k_dense_replace
    for chunk in chunks:
        (device,) = [r for r in records if r["name"] == "bank.device" and r["parent"] == chunk["id"]]
        inside = [r for r in records if r["parent"] == chunk["id"] and r["name"].startswith("moe.")]
        assert len(inside) == 2 * moe_layers + 1
        route = [r for r in inside if r["name"] == "moe.route"]
        experts = [r for r in inside if r["name"] == "moe.experts"]
        (counts,) = [r["attrs"]["counts"] for r in inside if r["name"] == "moe.tokens_per_expert"]
        assert [r["attrs"]["layer"] for r in route] == [r["attrs"]["layer"] for r in experts] \
            == list(range(moe_layers))
        for r, e in zip(route, experts):
            assert device["start_ns"] <= r["start_ns"] <= r["end_ns"] == e["start_ns"] \
                <= e["end_ns"] <= device["end_ns"]
        assert np.asarray(counts).shape == (moe_layers, TINY.n_routed_experts)
        assert np.asarray(counts).sum(axis=1).tolist() == \
            [chunk["attrs"]["computed_tokens"] * TINY.num_experts_per_tok] * moe_layers


def test_untraced_runs_make_no_device_clock(cuda_device, tmp_path, monkeypatch):
    """Without a profiler session neither ``extract()`` (through the card
    unfilter) nor the DeepSeek-V3 bank's ``_pool_tokens`` builds a
    ``DeviceClock``: with one that raises, both complete and record no span."""
    import chip_smoke
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.utils import profiling

    def refuse(*_args, **_kwargs):
        raise AssertionError("an untraced run built a DeviceClock")

    monkeypatch.setattr(profiling, "DeviceClock", refuse)
    profiling.reset_spans()
    rows = []
    for i, (h, w) in enumerate([(256, 208)] * 3):
        path = str(tmp_path / "2D_100micron" / f"view_{i}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        chip_smoke.write_png16(path, chip_smoke.synthetic_mammogram(h, w, seed=i), paeth=True)
        rows.append({"image_path": path})
    cfg = chip_smoke.store_config(str(tmp_path), ("", "", ""), str(tmp_path / "store"))
    ex = ImageFeatureExtractor(cfg, dataset=rows, batch_size=2, device=cuda_device)
    assert ex.extract() == len(rows)
    exp, loader = _moe_trainer(cuda_device, tmp_path / "bank")  # banks its rows untraced
    bank = exp._pool_tokens(loader(1).dataset._tokens)
    assert bank.shape[0] == 48 and bool(torch.isfinite(bank).all())
    assert profiling.spans() == []


# ----------------------------------------------------------------------
# the causal latent-attention kernel (csrc/mla_attention.cu)
# ----------------------------------------------------------------------
def _awkward_masks(s: int) -> np.ndarray:
    """Rows of length 1, without a valid key, with holes, left-padded, and whole."""
    pos = np.arange(s)
    hole = (pos < 2 * s // 3) & (pos != s // 4) & (pos != s // 2)
    return np.stack([pos < 1, np.zeros(s, bool), hole, pos >= s // 3, pos < s]).astype(np.int32)


MLA_DIMS = {"moonlight": dict(heads=16, nope=128, rope=64, vd=128, latent=512),
            "tiny": dict(heads=4, nope=16, rope=8, vd=16, latent=16)}


@pytest.mark.parametrize("rows,width,dims", [
    (256, 512, "moonlight"),  # a chunk of the bank cell, lengths drawn as it draws them
    (5, 33, "moonlight"),     # a query tile past s, a key tile of one key
    (5, 200, "moonlight"),
    (5, 40, "tiny"),          # the tests' tiny tower
])
def test_mla_attention_kernel_matches_plain(cuda_device, rows, width, dims):
    """Every output element, pad positions and queries without an allowed key
    included, within two bf16 steps of the largest, and each row's relative
    L2 within ``MLA_ROW_L2_TOL`` (the max alone would pass a wrong kernel: a
    position-0 query returns v_0, so the largest value is tens of times a
    typical one); one launch a call; a second launch bit-equal."""
    import chip_smoke

    if rows == 256:
        lengths = chip_smoke.bank_lengths(rows, 7)
        masks = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    else:
        masks = _awkward_masks(width)
    d = MLA_DIMS[dims]
    q, k_pe, kv, cos, sin, keys = chip_smoke.mla_layer_inputs(cuda_device, masks, **d)
    before = launch_counts()["mla_attention"]
    got = mla_attention(q, k_pe, kv, cos, sin, keys, d["heads"])
    assert launch_counts()["mla_attention"] == before + 1
    want = plain_mla_attention(q, k_pe, kv, cos, sin, keys, d["heads"])
    assert got.dtype == want.dtype and got.shape == want.shape
    err, row_l2 = chip_smoke.mla_errors(got, want)
    assert err <= BF16_REL_TOL and row_l2 <= chip_smoke.MLA_ROW_L2_TOL, (err, row_l2)
    assert torch.equal(launch_mla_attention(q, k_pe, kv, cos, sin, keys.bool(), d["heads"]), got)


@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_mla_attention_rotates_as_rope_pairs(cuda_device, dims):
    """The operands the kernel rotates on load (its debug outputs) bit-equal
    to ``rope_pairs`` on the card, and the context unchanged by asking."""
    import chip_smoke

    d = MLA_DIMS[dims]
    q, k_pe, kv, cos, sin, keys = chip_smoke.mla_layer_inputs(
        cuda_device, np.ones((3, 100), np.int32), **d)
    b, s, _ = q.shape
    out, q_rot, k_rot = launch_mla_attention(q, k_pe, kv, cos, sin, keys, d["heads"], rotated=True)
    assert torch.equal(q_rot, rope_pairs(q.view(b, s, d["heads"], -1)[..., d["nope"]:], cos, sin))
    assert torch.equal(k_rot, rope_pairs(k_pe[:, :, None], cos, sin)[:, :, 0])
    assert torch.equal(out, launch_mla_attention(q, k_pe, kv, cos, sin, keys, d["heads"]))


def test_mla_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    import chip_smoke

    q, k_pe, kv, cos, sin, keys = chip_smoke.mla_layer_inputs(
        cuda_device, np.ones((2, 40), np.int32))
    b, s, w = q.shape
    shifted = torch.empty(b, s, w + 1, dtype=q.dtype, device=q.device)[..., 1:]  # 2-byte offset
    shifted.copy_(q)
    strided = torch.empty(b, s, w, 2, dtype=q.dtype, device=q.device)[..., 0]
    strided.copy_(q)
    for args in [(q.float(), k_pe, kv), (q, k_pe.half(), kv), (shifted, k_pe, kv),
                 (strided, k_pe, kv), (q, k_pe, kv[..., :-16 * 8])]:
        with pytest.raises(ValueError):
            launch_mla_attention(*args, cos, sin, keys, 16)
    with pytest.raises(ValueError):
        launch_mla_attention(q, k_pe, kv, cos.double(), sin, keys, 16)


def test_the_bank_runs_its_attention_through_the_kernel(cuda_device, tmp_path, monkeypatch):
    """``_pool_tokens`` launches the kernel once a layer and chunk (27 a
    chunk of the Moonlight bank; the tiny tower has 3 layers), and its bank
    matches the bank of the plain attention on the card as the bf16 tower
    matches the reference on the CPU (relative L2 a row: median under
    1.5e-2, nine rows in ten under 3e-2; a token at a near routing tie may
    flip)."""
    from mmgclip_tpu_torch.models import deepseek_v3
    from torch_deepseek_v3 import TINY

    exp, loader = _moe_trainer(cuda_device, tmp_path)
    tokens = {k: np.concatenate([v] * 6) for k, v in loader(1).dataset._tokens.items()}  # 288 rows
    before = launch_counts()
    bank = exp._pool_tokens(tokens)
    after = launch_counts()
    assert after["mla_attention"] - before["mla_attention"] == TINY.num_hidden_layers * 2
    # two norms and kv_a's a layer, and the final, in each of the two chunks
    assert after["rms_norm"] - before["rms_norm"] == (3 * TINY.num_hidden_layers + 1) * 2
    monkeypatch.setattr(deepseek_v3, "mla_attention", plain_mla_attention)
    plain = exp._pool_tokens(tokens)
    errors = (bank - plain).norm(dim=1) / plain.norm(dim=1)
    assert float(errors.median()) < 1.5e-2 and float((errors > 3e-2).float().mean()) <= 0.1


# ----------------------------------------------------------------------
# the KDA scan kernel (csrc/kda.cu), the NoPE latent attention and a held
# range of the grouped expert kernel (the Kimi-Linear tower)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows,width,heads", [
    (256, 512, 32),  # a chunk of the bank cell, lengths drawn as it draws them
    (6, 130, 32),    # rows of 0, 1, 31, 32, 33 and 130 tokens
    (6, 130, 2),     # the card tests' tiny tower
])
def test_kda_kernel_matches_plain(cuda_device, rows, width, heads):
    """Every output element within two bf16 steps of the largest, each row
    within ``KDA_ROW_L2_TOL`` relative L2, zeros past each row's length
    (a row of no token included), one launch a call, a second launch
    bit-equal."""
    import chip_smoke
    from mmgclip_tpu_torch.ops.kda import kda, launch_kda, plain_kda

    if rows == 256:
        lengths = chip_smoke.bank_lengths(rows, 7)
    else:
        lengths = np.array([0, 1, 31, 32, 33, width])
    args = chip_smoke.kda_layer_inputs(cuda_device, lengths, width, heads=heads)
    before = launch_counts()["kda"]
    got = kda(*args)
    assert launch_counts()["kda"] == before + 1
    want = plain_kda(*args)
    err, row_l2 = chip_smoke.kda_errors(got[lengths > 0], want[lengths > 0])
    assert err <= BF16_REL_TOL and row_l2 <= chip_smoke.KDA_ROW_L2_TOL, (err, row_l2)
    pad = torch.arange(width, device=cuda_device)[None, :] >= args[-1][:, None]
    assert not got[pad].any() and bool(torch.isfinite(got).all())
    assert torch.equal(launch_kda(*args), got)


@pytest.mark.parametrize("variant", [{"reset_every": 64}, {"head_decay": True},
                                     {"state_dtype": torch.bfloat16}])
def test_kda_kernel_variants_match_plain(cuda_device, variant):
    """The planted faults' variants on the card as on the CPU (a bf16 state
    rounds at every token on both sides, so their paths part a little
    further: 4 bf16 steps of the largest, 3e-2 a row), and each differs from
    the sound scan."""
    import chip_smoke
    from mmgclip_tpu_torch.ops.kda import launch_kda, plain_kda

    lengths = chip_smoke.bank_lengths(16, 9)
    args = chip_smoke.kda_layer_inputs(cuda_device, lengths, 512)
    got = launch_kda(*args, **variant)
    want = plain_kda(*args, **variant)
    err, row_l2 = chip_smoke.kda_errors(got, want)
    loose = "state_dtype" in variant
    assert err <= (4 if loose else 1) * BF16_REL_TOL, err
    assert row_l2 <= (3e-2 if loose else chip_smoke.KDA_ROW_L2_TOL), row_l2
    sound = launch_kda(*args)
    assert float((got.float() - sound.float()).norm() / sound.float().norm()) > 1e-3


@pytest.mark.parametrize("rows,width,heads", [(256, 512, 32), (5, 40, 32), (5, 40, 4)])
def test_mla_attention_nope_path_matches_plain(cuda_device, rows, width, heads):
    """Without rope tables the kernel leaves q_pe and k_pe unrotated, as the
    plain path does: within two bf16 steps of the largest and
    ``MLA_ROW_L2_TOL`` a row, at Kimi-Linear's 32 heads (a bank chunk and
    awkward masks) and the tiny tower's dims; equal to the kernel given
    tables of no turn."""
    import chip_smoke

    if rows == 256:
        lengths = chip_smoke.bank_lengths(rows, 5)
        masks = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    else:
        masks = _awkward_masks(width)
    d = dict(MLA_DIMS["moonlight" if heads == 32 else "tiny"], heads=heads)
    q, k_pe, kv, cos, sin, keys = chip_smoke.mla_layer_inputs(cuda_device, masks, **d)
    got = mla_attention(q, k_pe, kv, None, None, keys, heads)
    want = plain_mla_attention(q, k_pe, kv, None, None, keys, heads)
    err, row_l2 = chip_smoke.mla_errors(got, want)
    assert err <= BF16_REL_TOL and row_l2 <= chip_smoke.MLA_ROW_L2_TOL, (err, row_l2)
    still = launch_mla_attention(q, k_pe, kv, torch.ones_like(cos), torch.zeros_like(sin), keys,
                                 heads)
    assert torch.equal(got, still)


def test_moe_experts_kernel_over_a_held_range(cuda_device):
    """Experts 0-127 of a 256-expert top-8 router at Kimi-Linear's widths
    (2304 -> 1024): the kernel over the held range against the plain version,
    the slots of experts not held zero, and the held range's plan counting
    only its own rows."""
    tokens, D, I, E, k = 8192, 2304, 1024, 256, 8
    g = torch.Generator(device=cuda_device).manual_seed(21)
    x = torch.randn(tokens, D, generator=g, device=cuda_device).to(torch.bfloat16)
    w_gate_up = (0.02 * torch.randn(E // 2, 2 * I, D, generator=g, device=cuda_device)
                 ).to(torch.bfloat16)
    w_down = (0.02 * torch.randn(E // 2, D, I, generator=g, device=cuda_device)).to(torch.bfloat16)
    chosen = torch.topk(torch.randn(tokens, E, generator=g, device=cuda_device), k).indices
    weights = torch.rand(tokens, k, generator=g, device=cuda_device) + 0.1
    plan = dispatch(chosen, E, range(0, E // 2))
    assert int(plan.counts.sum()) == int((chosen < E // 2).sum())
    got = launch_moe_experts(x, plan, weights, w_gate_up, w_down)
    want = plain_moe_experts(x, plan, weights, w_gate_up, w_down)
    assert float((got - want).abs().max() / want.abs().max()) <= BF16_REL_TOL
    none_held = (chosen >= E // 2).all(dim=1)
    assert bool(none_held.any()) and not got[none_held].any()
    assert torch.equal(launch_moe_experts(x, plan, weights, w_gate_up, w_down), got)


def test_the_kimi_bank_runs_its_kernels_and_records_its_spans(cuda_device, tmp_path):
    """The tiny Kimi-Linear tower's trainer on the card: ``_pool_tokens``
    launches the KDA kernel once a KDA layer and chunk and the NoPE latent
    attention once an MLA layer and chunk; its bank matches the bank of the
    plain paths on the card (as the bf16 tower matches the reference on the
    CPU); under a profiler each chunk records one ``kda.layer`` with one
    ``kda.scan`` inside it a KDA layer, and the held experts' counts with
    their range."""
    from mmgclip_tpu_torch.cli import DEFAULT_CONFIG_DIR
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.models import kimi_linear
    from mmgclip_tpu_torch.ops.kda import plain_kda
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment
    from mmgclip_tpu_torch.utils import profiling
    from torch_kimi_linear import TINY_FIELDS, hf_weights, tiny_override

    from mmgclip_tpu_torch.models.kimi_linear import KimiLinearConfig

    card = dict(kda_num_heads=2, kda_head_dim=128)  # the kernel's head size
    TINY = KimiLinearConfig(**dict(TINY_FIELDS, **card))

    rng = np.random.default_rng(4)
    n, s = 300, 40
    lengths = rng.integers(1, s + 1, n)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    tokens = {"input_ids": rng.integers(0, TINY.vocab_size, (n, s)).astype(np.int32) * mask,
              "attention_mask": mask}

    class Rows:
        _features = rng.normal(size=(48, 768)).astype(np.float32)
        _tokens = {k: v[:48] for k, v in tokens.items()}

        def __len__(self):
            return 48

    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf",
                  ["networks=clip_convnext_kimi_linear_text", "projection=2xLinear512",
                   tiny_override(**card), "dataloader.train.batch_size=8", "base.seed=0"],
                  run_dir=str(tmp_path))
    cfg.base.tensorboard_export_dir = str(tmp_path / "tb")
    exp = ClassifierExperiment(config=cfg, train_dataloader=DataLoader(Rows(), batch_size=8,
                                                                       drop_last=True),
                               device=cuda_device, text_weights=hf_weights(TINY, seed=2,
                                                                           bias_std=1.0))
    before = launch_counts()
    bank = exp._pool_tokens(tokens)
    after = launch_counts()
    kda_layers = len(TINY.kda_layers)
    assert after["kda"] - before["kda"] == 2 * kda_layers
    assert after["mla_attention"] - before["mla_attention"] == 2 * len(TINY.full_attn_layers)
    # a chunk: two norms a layer, kv_a's in each MLA layer, the gate in each KDA layer, the final
    norms = 2 * TINY.num_hidden_layers + len(TINY.full_attn_layers) + kda_layers + 1
    assert after["rms_norm"] - before["rms_norm"] == 2 * norms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kimi_linear, "kda_scan", plain_kda)
        from mmgclip_tpu_torch.models import deepseek_v3
        mp.setattr(deepseek_v3, "mla_attention", plain_mla_attention)
        plain = exp._pool_tokens(tokens)
    errors = (bank - plain).norm(dim=1) / plain.norm(dim=1)
    assert float(errors.median()) < 1.5e-2 and float((errors > 3e-2).float().mean()) <= 0.1

    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        exp._pool_tokens(tokens)
    records = profiling.spans()
    chunks = [r for r in records if r["name"] == "bank.chunk"]
    assert len(chunks) == 2
    for chunk in chunks:
        inside = [r for r in records if r["parent"] == chunk["id"]]
        layers = [r for r in inside if r["name"] == "kda.layer"]
        assert [r["attrs"]["layer"] for r in layers] == list(range(kda_layers))
        for layer in layers:
            (scan,) = [r for r in records if r["parent"] == layer["id"]]
            assert scan["name"] == "kda.scan"
            assert layer["start_ns"] <= scan["start_ns"] <= scan["end_ns"] <= layer["end_ns"]
        (counts,) = [r for r in inside if r["name"] == "moe.tokens_per_expert"]
        assert counts["attrs"]["held"] == list(TINY.experts_held)
        assert np.asarray(counts["attrs"]["counts"]).shape == (TINY.num_hidden_layers - 1, 8)
    profiling.reset_spans()
    exp._pool_tokens(tokens)  # no profiler: nothing recorded
    assert profiling.spans() == []


# ----------------------------------------------------------------------
# the RMSNorm kernel (csrc/rms_norm.cu)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows,width,stride,gate,dtype", [
    (1001, 128, 128, True, torch.bfloat16),    # the KDA output gate's per-head rows
    (777, 512, 576, False, torch.bfloat16),    # kv_a_layernorm over the split view
    (333, 2048, 2048, False, torch.bfloat16),  # Moonlight's hidden rows
    (517, 2304, 2304, False, torch.bfloat16),  # Kimi-Linear's hidden rows
    (517, 2304, 2304, False, torch.float32),   # the final norm
    (1, 2304, 2304, True, torch.float32),
    (9, 16, 24, False, torch.bfloat16),        # the tiny towers' c_kv view
    (37, 64, 64, False, torch.float32),        # the tiny towers' final norm
    (13, 1000, 1000, False, torch.bfloat16),   # a width between the classes
])
def test_rms_norm_kernel_matches_plain(cuda_device, rows, width, stride, gate, dtype):
    """Every bf16 element within one bf16 step of the plain path's on the
    card (float32 outputs within 1e-6 of the largest), one launch a call,
    a second launch bit-equal, the strided input read in place."""
    import chip_smoke

    x, w, r = chip_smoke.rms_norm_inputs(cuda_device, rows, width, stride, gate, seed=rows)
    before = launch_counts()["rms_norm"]
    got = rms_norm(x, w, 1e-5, dtype, r)
    assert launch_counts()["rms_norm"] == before + 1
    assert got.shape == x.shape and got.dtype == dtype and got.is_contiguous()
    err = chip_smoke.rms_norm_errors(got, plain_rms_norm(x, w, 1e-5, dtype, r))
    assert err <= (chip_smoke.RMS_NORM_FP32_REL_TOL if dtype == torch.float32 else 1.0), err
    assert bool(torch.isfinite(got).all())
    assert torch.equal(launch_rms_norm(x, w, 1e-5, dtype, r), got)


def test_rms_norm_rows_depend_on_themselves_alone(cuda_device):
    """A row's output is the same alone as among others (no row reads
    another), and rows of zeros come out zero."""
    import chip_smoke

    x, w, _r = chip_smoke.rms_norm_inputs(cuda_device, 300, 2304, 2304, False)
    x = x.clone()
    x[7] = 0
    whole = launch_rms_norm(x, w, 1e-5)
    assert not whole[7].any()
    for row in (0, 7, 150, 299):
        assert torch.equal(launch_rms_norm(x[row:row + 1], w, 1e-5), whole[row:row + 1])


def test_rms_norm_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=cuda_device)
    w = torch.ones(64, dtype=torch.bfloat16, device=cuda_device)
    before = launch_counts()["rms_norm"]
    with pytest.raises(ValueError, match="bf16"):
        launch_rms_norm(x.float(), w, 1e-5)
    with pytest.raises(ValueError, match="writes bf16 or float32"):
        launch_rms_norm(x, w, 1e-5, torch.float16)
    with pytest.raises(ValueError, match="multiple of 8"):
        launch_rms_norm(x[:, :60], w[:60], 1e-5)
    with pytest.raises(ValueError, match="weight"):
        launch_rms_norm(x, w.float(), 1e-5)
    with pytest.raises(ValueError, match="row stride"):
        launch_rms_norm(torch.zeros(4, 68, dtype=torch.bfloat16, device=cuda_device)[:, :64], w,
                        1e-5)
    with pytest.raises(ValueError, match="rows of one stride"):
        launch_rms_norm(torch.zeros(4, 4, 64, dtype=torch.bfloat16,
                                    device=cuda_device).transpose(0, 1), w, 1e-5)
    with pytest.raises(ValueError, match="gate"):
        launch_rms_norm(x, w, 1e-5, gate=x[:2])
    assert launch_counts()["rms_norm"] == before


@pytest.mark.parametrize("tower", ["moonlight", "kimi"])
def test_a_tower_forward_launches_a_norm_per_rmsnorm(cuda_device, tower):
    """A tiny tower's forward on the card launches the kernel once for each
    RMSNorm it runs (Moonlight: input, post-attention and kv_a norms a
    layer and the final; Kimi: kv_a only in its MLA layers, the gated o_norm
    in its KDA layers) and matches its forward on the CPU as the bf16 tower
    matches the reference (relative L2 a token, median under 1.5e-2)."""
    if tower == "moonlight":
        from mmgclip_tpu_torch.models.deepseek_v3 import (DeepseekV3TextEncoder as Tower,
                                                          load_deepseek_v3_weights as load)
        from torch_deepseek_v3 import TINY as c

        norms = 3 * c.num_hidden_layers + 1
        from test_torch_deepseek_v3 import hf_weights

        weights = hf_weights(c, seed=1)
    else:
        from mmgclip_tpu_torch.models.kimi_linear import KimiLinearConfig
        from mmgclip_tpu_torch.models.kimi_linear import KimiLinearTextEncoder as Tower
        from mmgclip_tpu_torch.models.kimi_linear import load_kimi_linear_weights as load
        from torch_kimi_linear import TINY_FIELDS, hf_weights

        c = KimiLinearConfig(**dict(TINY_FIELDS, kda_num_heads=2, kda_head_dim=128))
        norms = 2 * c.num_hidden_layers + len(c.full_attn_layers) + len(c.kda_layers) + 1
        weights = hf_weights(c, seed=1, bias_std=1.0)
    cpu = Tower(c, device="meta")
    load(cpu, {k: v.clone() for k, v in weights.items()})
    card = Tower(c, device="meta")
    load(card, weights, device=cuda_device)
    g = torch.Generator().manual_seed(2)
    lengths = torch.tensor([24, 17, 5, 1])
    mask = (torch.arange(24)[None] < lengths[:, None]).to(torch.int32)
    ids = torch.randint(0, c.vocab_size, (4, 24), generator=g) * mask
    before = launch_counts()["rms_norm"]
    with torch.no_grad():
        got = card(ids.to(cuda_device), attention_mask=mask.to(cuda_device))
        assert launch_counts()["rms_norm"] - before == norms
        want = cpu(ids, attention_mask=mask)
    valid = mask > 0
    errors = (got.cpu() - want)[valid].norm(dim=1) / want[valid].norm(dim=1)
    assert float(errors.median()) < 1.5e-2
