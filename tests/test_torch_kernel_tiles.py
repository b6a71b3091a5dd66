"""The tile orders of the int8 block and downsample kernels, emulated in
torch on the CPU (the kernels themselves run only on the card, in
``test_torch_cuda.py``).

* ``csrc/fused_block.cu``'s ln_mlp_int8 packs its weights four K rows to a
  word (``pack_int8_rows``) and walks the hidden units in chunks, twice: pass
  1 takes each row's max |GELU| over every chunk (and over the CTAs of a
  cluster), pass 2 quantises each chunk with that row's scale and adds the
  chunks' int32 partial sums.  The emulation below follows that order and
  must give ``plain_convnext_block_int8``'s int32 sums and outputs bit for
  bit: the kernel changes where the products are summed, never what is
  quantised.
* ``csrc/fused_downsample.cu`` writes the LN'd 2 x 2 patch of output pixel p
  into row p of its A tile at column (dy * 2 + dx) * Cin + ci; that row
  order must be ``patchify(., 2)``'s, which the plain version and the JAX
  lax math use.
* ``csrc/fused_stem.cu`` stages, per tile of ``STEM_TILE`` output pixels of
  one output row, the four input row spans and reads each A-fragment value
  k = dy * 4 Cin + r of pixel p from element 4 p Cin + r of staged row dy,
  zero past the span (past W, past H).  That A tile must be ``patchify(.,
  4)``'s bit for bit; the products (bf16 per k step of 16, or the three-pass
  TF32 split per k step of 8 in a fresh sum) over N padded to 8, and the LN
  over the true Cout, must give ``plain_stem``'s output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmgclip_tpu.ops.fused_downsample import _lax_ln_downsample
from mmgclip_tpu.ops.fused_stem import _lax_stem
from mmgclip_tpu_torch.ops.fused_block import (
    EPS,
    INV_127,
    pack_int8_rows,
    plain_convnext_block_int8,
    quantize_rows,
    quantize_weights,
)
from mmgclip_tpu_torch.ops.fused_downsample import plain_ln_downsample
from mmgclip_tpu_torch.ops.fused_stem import EPS as STEM_EPS
from mmgclip_tpu_torch.ops.fused_stem import patchify, plain_stem
from mmgclip_tpu_torch.ops.quant import EPS as QUANT_EPS
from mmgclip_tpu_torch.ops.quant import int8_matmul


def unpack_int8_rows(words: torch.Tensor) -> torch.Tensor:
    """[k/4, m] int32 -> [k, m] int8, the inverse of ``pack_int8_rows``: byte
    b (the lowest first) of word (i, j) is row 4i + b of column j."""
    q, m = words.shape
    return words.contiguous().view(torch.int8).reshape(q, m, 4).permute(0, 2, 1).reshape(4 * q, m)


def hidden_chunk(c: int) -> int:
    """Hidden units per chunk of ``plan_mlp_int8``: 64 a warp, ceil(Cp / 96)
    warps across, Cp = C rounded up to 32."""
    cp = -(-c // 32) * 32
    return 64 * -(-cp // 96)


def block_inputs(shape, dtype, seed):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + rng.standard_normal(s) * scale).astype(np.float32))

    x = f(n, h, w, c).to(dtype)
    params = [f(7, 7, 1, c, scale=0.2), f(c, scale=0.1), f(c, scale=0.1, offset=1.0), f(c, scale=0.1),
              f(c, 4 * c, scale=c ** -0.5), f(4 * c, scale=0.1), f(4 * c, c, scale=(4 * c) ** -0.5),
              f(c, scale=0.1), f(c, scale=0.5)]
    return x, [t if i in (2, 3) else t.to(dtype) for i, t in enumerate(params)]


def emulate_int8_block(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, hn, split, gelu_tanh=False):
    """The kernel's order: per-row s1; pass 1's max |GELU| over the chunks of
    every CTA of the cluster; each chunk quantised with the row's s2; the
    chunks' int32 partial sums added per CTA, then over the CTAs (the DSMEM
    sum); one dequantisation.  -> (out, int32 sums)."""
    c = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), dwk.float().permute(3, 2, 0, 1), padding=3,
                 groups=c).permute(0, 2, 3, 1) + dwb.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + EPS) * ns.float() + nb.float()
    w1q, ws1, w2q, ws2 = (unpack_int8_rows(pack_int8_rows(w)) if w.dtype == torch.int8 else w
                          for w in quantize_weights(w1, w2))
    q1, s1 = quantize_rows(y)
    chunks = [slice(j, min(j + hn, 4 * c)) for j in range(0, 4 * c, hn)]

    def gelu_chunk(cols):  # pw1, dequantise, b1, GELU: the same code in both passes
        h = int8_matmul(q1, w1q[:, cols]).float() * (s1 * ws1[cols]) + b1.float()[cols]
        return F.gelu(h, approximate="tanh" if gelu_tanh else "none")

    amax = torch.zeros_like(s1)
    for cols in chunks:  # pass 1
        amax = torch.maximum(amax, gelu_chunk(cols).abs().amax(dim=-1, keepdim=True))
    s2 = torch.clamp(amax, min=QUANT_EPS) * INV_127
    # the chunks of CTA `rank`: chunk0 = rank * (chunks / split) + min(rank, chunks % split)
    per, extra = divmod(len(chunks), split)
    sums = []
    for rank in range(split):
        first = rank * per + min(rank, extra)
        mine = chunks[first:first + per + (1 if rank < extra else 0)]
        part = torch.zeros(*x.shape[:-1], c, dtype=torch.int32)
        for cols in mine:  # pass 2
            q2 = torch.clamp(torch.round(gelu_chunk(cols) / s2), -127, 127).to(torch.int8)
            part += int8_matmul(q2, w2q[cols])
        sums.append(part)
    total = sums[0]
    for part in sums[1:]:
        total = total + part
    out = (total.float() * (s2 * ws2) + b2.float()) * g.float()
    return (x.float() + out).to(x.dtype), total


@pytest.mark.parametrize("c", [8, 20, 96, 768])
def test_int8_weight_packing_round_trips(c):
    rng = np.random.default_rng(c)
    for shape in ((c, 4 * c), (4 * c, c)):
        q = torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))
        words = pack_int8_rows(q)
        assert words.dtype == torch.int32 and tuple(words.shape) == (shape[0] // 4, shape[1])
        assert torch.equal(unpack_int8_rows(words), q)
        # the B fragment: word (i, j) holds rows 4i..4i+3 of column j, row 4i lowest
        w = int(words[1, 2]) & 0xFFFFFFFF
        assert [((w >> (8 * b)) & 0xFF) for b in range(4)] == [int(v) & 0xFF for v in q[4:8, 2]]


@pytest.mark.parametrize("c,shape", [(8, (1, 7, 5)), (16, (2, 3, 5)), (96, (1, 9, 7)),
                                     (768, (1, 3, 5))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_int8_two_pass_order_is_bit_equal_to_plain(c, shape, dtype, gelu_tanh):
    x, params = block_inputs((*shape, c), dtype, seed=c)
    ref = plain_convnext_block_int8(x, *params, gelu_tanh=gelu_tanh)
    hn = hidden_chunk(c)
    assert hn == {8: 64, 16: 64, 96: 64, 768: 512}[c]
    for split in sorted({1, min(2, -(-4 * c // hn))}):
        out, sums = emulate_int8_block(x, *params, hn=hn, split=split, gelu_tanh=gelu_tanh)
        assert torch.equal(out.view(torch.uint8) if dtype == torch.bfloat16 else out,
                           ref.view(torch.uint8) if dtype == torch.bfloat16 else ref)
        # the int32 sums of the plain version, one matmul over all 4C
        y_ref = plain_sums(x, *params, gelu_tanh=gelu_tanh)
        assert torch.equal(sums, y_ref)


def plain_sums(x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, gelu_tanh=False):
    """pw2's int32 sums as ``plain_convnext_block_int8`` forms them."""
    c = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), dwk.float().permute(3, 2, 0, 1), padding=3,
                 groups=c).permute(0, 2, 3, 1) + dwb.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + EPS) * ns.float() + nb.float()
    w1q, ws1, w2q, _ws2 = quantize_weights(w1, w2)
    q1, s1 = quantize_rows(y)
    h = F.gelu(int8_matmul(q1, w1q).float() * (s1 * ws1) + b1.float(),
               approximate="tanh" if gelu_tanh else "none")
    q2, _s2 = quantize_rows(h)
    return int8_matmul(q2, w2q)


def downsample_a_tile(y: torch.Tensor) -> torch.Tensor:
    """The kernel's A tile for all output pixels: row p = output pixel p of
    the flattened n * ceil(H/2) * ceil(W/2) range, column (dy * 2 + dx) *
    Cin + ci = y[2 oy + dy, 2 ox + dx, ci], zero past H, W."""
    n, h, w, cin = y.shape
    ho, wo = -(-h // 2), -(-w // 2)
    a = torch.zeros(n * ho * wo, 4 * cin, dtype=y.dtype)
    for p in range(n * ho * wo):
        img, rem = divmod(p, ho * wo)
        oy, ox = divmod(rem, wo)
        for tap in range(4):
            yy, xx = 2 * oy + (tap >> 1), 2 * ox + (tap & 1)
            if yy < h and xx < w:
                a[p, tap * cin:(tap + 1) * cin] = y[img, yy, xx]
    return a


@pytest.mark.parametrize("shape,cout", [((1, 7, 5, 8), 16), ((2, 9, 13, 16), 32),
                                        ((1, 5, 5, 96), 192)])
def test_downsample_a_tile_order_is_patchify(shape, cout):
    rng = np.random.default_rng(11)
    n, h, w, cin = shape
    x = (rng.standard_normal(shape)).astype(np.float32)
    ns = (1 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    nb = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    k = (rng.standard_normal((2, 2, cin, cout)) * (4 * cin) ** -0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    xt = torch.from_numpy(x)
    mean = xt.mean(dim=-1, keepdim=True)
    var = (xt - mean).square().mean(dim=-1, keepdim=True)
    y = (xt - mean) * torch.rsqrt(var + EPS) * torch.from_numpy(ns) + torch.from_numpy(nb)
    a = downsample_a_tile(y)
    assert torch.equal(a, patchify(y, 2).reshape(-1, 4 * cin))
    # the GEMM over that A tile is the downsample, as the port's plain
    # version and the JAX lax math compute it
    out = (a @ torch.from_numpy(k).reshape(4 * cin, cout) + torch.from_numpy(b)).reshape(
        n, -(-h // 2), -(-w // 2), cout)
    ref = plain_ln_downsample(xt, *(torch.from_numpy(v) for v in (ns, nb, k, b)))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    lax = np.asarray(_lax_ln_downsample(*map(jnp.asarray, (x, ns, nb, k, b))))
    np.testing.assert_allclose(out.numpy(), lax, rtol=1e-5, atol=1e-5)


# ---- stem ----------------------------------------------------------------
STEM_TILE = 64  # output pixels of a tile of csrc/fused_stem.cu (16 a warp, 4 warps)


def stem_staged_rows(x, img, oy, ox0):
    """The four input row spans of one tile as the kernel stages them: row dy
    holds x[img, 4 oy + dy, 4 ox0 :, :] flattened, ``lens[dy]`` elements (0
    past H); what lies past a span is stale (NaN here), so only the guard
    keeps it out."""
    _n, h, w, cin = x.shape
    count = min(4 * STEM_TILE, w - 4 * ox0) * cin
    rows = torch.full((4, 4 * STEM_TILE * cin), float("nan"), dtype=x.dtype)
    lens = []
    for dy in range(4):
        yy = 4 * oy + dy
        lens.append(count if yy < h else 0)
        if yy < h:
            rows[dy, :count] = x[img, yy].reshape(-1)[4 * ox0 * cin:4 * ox0 * cin + count]
    return rows, lens


def stem_a_tile(rows, lens, cin):
    """A [STEM_TILE, 16 Cin]: column k = dy * 4 Cin + r of pixel p is element
    4 p Cin + r of staged row dy, 0 where that is past the row's span."""
    k4 = 4 * cin
    idx = torch.arange(STEM_TILE)[:, None] * k4 + torch.arange(k4)[None, :]
    return torch.cat([torch.where(idx < lens[dy], rows[dy][idx], torch.zeros((), dtype=rows.dtype))
                      for dy in range(4)], dim=1)


def tf32(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def emulate_stem(x, k, b, ns, nb):
    """The kernel's tile order -> (out, the A tile of every pixel)."""
    n, h, w, cin = x.shape
    cout = k.shape[3]
    ho, wo = -(-h // 4), -(-w // 4)
    npad = -(-cout // 8) * 8
    wmat = torch.zeros(16 * cin, npad)
    wmat[:, :cout] = k.float().reshape(16 * cin, cout)
    bias = torch.zeros(npad)
    bias[:cout] = b.float()
    a_all = torch.zeros(n, ho, wo, 16 * cin, dtype=x.dtype)
    out = torch.zeros(n, ho, wo, cout, dtype=x.dtype)
    for tile in range(n * ho * -(-wo // STEM_TILE)):  # the grid stride visits every tile once
        row, tx = divmod(tile, -(-wo // STEM_TILE))
        img, oy = divmod(row, ho)
        ox0 = tx * STEM_TILE
        a = stem_a_tile(*stem_staged_rows(x, img, oy, ox0), cin)
        live = min(STEM_TILE, wo - ox0)
        a_all[img, oy, ox0:ox0 + live] = a[:live]
        a = a.to(k.dtype).float()  # rounded to the weight dtype on the way into the fragments
        acc = bias.expand(STEM_TILE, npad).clone()
        if k.dtype == torch.bfloat16:  # m16n8k16: k steps of 16
            for ks in range(cin):
                sl = slice(16 * ks, 16 * ks + 16)
                acc = acc + a[:, sl] @ wmat[sl]
        else:  # m16n8k8 three-pass TF32, each step's products in a fresh sum
            for ks in range(2 * cin):
                sl = slice(8 * ks, 8 * ks + 8)
                ahi, bhi = tf32(a[:, sl]), tf32(wmat[sl])
                alo, blo = tf32(a[:, sl] - ahi), tf32(wmat[sl] - bhi)
                step = alo @ bhi
                step = step + ahi @ blo
                step = step + ahi @ bhi
                acc = acc + step
        assert torch.equal(acc[:, cout:], torch.zeros(STEM_TILE, npad - cout))  # zero-padded N
        y = acc[:, :cout]  # the LN's statistics over the true Cout only
        mean = y.sum(dim=-1, keepdim=True) / cout
        var = (y - mean).square().sum(dim=-1, keepdim=True) / cout
        o = (y - mean) * (1.0 / torch.sqrt(var + STEM_EPS)) * ns + nb
        out[img, oy, ox0:ox0 + live] = o[:live].to(x.dtype)
    return out, a_all


# odd H and W; (1, 5, 270, 3): two tiles per output row, the last ragged (4 of 64)
@pytest.mark.parametrize("shape", [(1, 9, 13, 1), (2, 7, 11, 3), (1, 5, 270, 3)])
@pytest.mark.parametrize("cout", [8, 20, 96])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_stem_tile_order_is_patchify(shape, cout, w_dtype):
    rng = np.random.default_rng(13)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((4, 4, cin, cout)) * (16 * cin) ** -0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ns = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
    nb = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    xt, kt, bt = torch.from_numpy(x), torch.from_numpy(k).to(w_dtype), torch.from_numpy(b).to(w_dtype)
    nst, nbt = torch.from_numpy(ns), torch.from_numpy(nb)
    out, a = emulate_stem(xt, kt, bt, nst, nbt)
    assert torch.equal(a, patchify(xt, 4))
    ref = plain_stem(xt, kt, bt, nst, nbt)
    assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
    if w_dtype == torch.float32:  # and the JAX lax stem on the same inputs
        lax = np.asarray(_lax_stem(*map(jnp.asarray, (x, k, b, ns, nb))))
        np.testing.assert_allclose(out.numpy(), lax, rtol=1e-5, atol=1e-5)
