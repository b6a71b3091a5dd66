// The ConvNeXt stem in one kernel, for sm_90a: a 4x4/4 patchify conv, its
// bias and a LayerNorm over the output channels,
//
//     out[p, :] = LN(round_to(TW, patch(x, p)) . k + bias)   (fp32 LN, eps 1e-6)
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/fused_stem.py
// (`_fused_call` / `_kernel`).  The TPU needed the 4x4 patches gathered into
// a [rows, 16*Cin] array by XLA before the kernel; here the kernel reads the
// NHWC input itself (zeros past the true H, W: the bottom/right `br_pad` of
// the JAX tower), so the input is read once and the conv output never leaves
// registers before the LN.
//
// Layout: x [n, H, W, Cin] (TX); k [16*Cin, Cout] (TW), rows in (dy, dx, ci)
// order, which is the HWIO kernel [4, 4, Cin, Cout] reshaped; bias [Cout]
// (TW); ns / nb [Cout] fp32; out [n, ceil(H/4), ceil(W/4), Cout] in TX.
// Cin <= 4, Cout <= 256.  Patch values are rounded to TW (the JAX kernel
// casts the patches to the weight dtype), products accumulate in fp32.
//
// What bounds it: 2*16*Cin*Cout operations per output pixel against
// 16*Cin*sizeof(TX) bytes in and Cout*sizeof(TX) out; at Cin = 3, Cout = 96
// in fp32 that is 9.2 kFLOP per 576 bytes, far below the tensor cores'
// ~295 operations a byte: bytes.  So the design keeps HBM busy:
//
// * Persistent CTAs (as many as fit on each SM) load the weights, bias and
//   LN affine once, the weights straight into the mma's B-fragment order,
//   then walk the output tiles with a grid stride.
// * A tile is one output row segment of TILE = 64 pixels; its input is four
//   contiguous spans of 4*TILE*Cin elements, one per input row.  They are
//   copied by 16-byte cp.async into a double-buffered stage, the next
//   tile's copies in flight while a tile computes (a deeper ring gained
//   nothing: the time goes to the compute chain and the stores).  An input
//   row's pitch W*Cin*sizeof(TX) need not be a multiple of 16 (22,968 bytes
//   at 2294x1914x3 fp32), so each span lands at the same offset mod 16 as in
//   global memory: every copy but the head one is aligned; the head chunk's
//   bytes of the span are copied element by element, the tail chunk is
//   zero-filled past the span.
// * Products on the tensor cores: warp w owns the tile's pixels [16w,
//   16w + 16) and all Cout columns (padded to a multiple of 8 with zero
//   weights).  bf16 weights run mma.sync m16n8k16 with the patches rounded
//   to bf16 on the way into the A fragments (each product exact in fp32);
//   fp32 weights run m16n8k8 TF32 in the three-pass split (the weights
//   split as they are read, which keeps their fragments at 64 KB for Cin =
//   4, Cout = 256), each k step's products summed in a fresh accumulator and
//   added to the running sum in fp32 (the fp32 downsample's order).
//   K = 16*Cin needs no padding.
// * The LN in registers: a row of the m16n8 accumulators lives in one quad,
//   so the two-pass mean / variance over the true Cout columns take two
//   quad shuffles each.
// * 16-byte output stores.  fp32 out with Cout % 4 == 0 (the tower's
//   stems): the lanes t, t ^ 1 of a quad swap half their LN'd pairs by one
//   shuffle each, so every lane holds 4 consecutive columns of one row and
//   stores them from registers; each store instruction fills whole 32-byte
//   sectors.  (Staging through shared memory conflicted 8 ways there: the
//   row pitch of 96 words puts one column of all 8 rows on one bank.)
//   Otherwise each warp's 16 output pixels, one contiguous span of out, are
//   staged in shared memory at the span's offset mod 16 and written by
//   16-byte stores, element stores only at a ragged head or tail.
// No atomics: two launches give the same bits.

#include "common.cuh"

namespace {

using namespace mmg;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;  // output pixels of a tile: one row segment
constexpr int MAX_CIN = 4;
constexpr int MAX_COUT = 256;

struct Geo {
  int h, w, cin, cout, ho, wo;
  int tpr;           // tiles per output row
  int tiles;         // n * ho * tpr
  int nblk, np;      // 8-column blocks of the output; Cout padded to 8
  int row_bytes;     // one staged input row: 4 * TILE * Cin * sizeof(TX) + 16
  int out_bytes;     // one warp's staged output: 16 * Cout * sizeof(TX) + 16 (0 with vec_out)
  int vec_out;       // fp32 out, Cout % 4 == 0: 4-column vectors stored from registers
};

template <typename TW> __host__ __device__ constexpr bool bf16_weights() { return sizeof(TW) == 2; }

// k steps of the mma: 16 deep in bf16, 8 in TF32
template <typename TW> int ksteps(int cin) { return bf16_weights<TW>() ? cin : 2 * cin; }

// the B fragments: 8 bytes a lane per k step and 8-column block
template <typename TW> size_t frag_bytes(const Geo& g) {
  return (size_t)ksteps<TW>(g.cin) * g.nblk * 32 * 8;
}

// per stage and input row: (the span's byte offset mod 16, its elements)
constexpr int META_BYTES = 2 * 4 * sizeof(int2);

template <typename TW> size_t smem_bytes(const Geo& g) {
  return META_BYTES + (size_t)3 * g.np * sizeof(float) + frag_bytes<TW>(g) +
         (size_t)8 * g.row_bytes + (size_t)WARPS * g.out_bytes;
}

// one element of T between two addresses (shared or global), as raw bits
template <int SIZE> __device__ __forceinline__ void copy_elem(void* dst, const void* src) {
  if constexpr (SIZE == 4) {
    *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
  } else {
    *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
  }
}

// NB: 8-column blocks a warp holds (at least nblk); FULL: Cout == 8 * NB,
// so no column is padding and no guard is needed.  Up to Cout = 96 the
// registers are capped at 128 a thread, so that 16 warps fit on an SM (left
// alone ptxas takes 150-190 and 8-12 warps fit, and each tile's chain of
// shared loads, products, shuffles and stores is then too exposed)
template <typename TX, typename TW, int NB, bool FULL>
__global__ void __launch_bounds__(THREADS, NB <= 12 ? 16 / WARPS : 1)
stem_kernel(const TX* __restrict__ x, const TW* __restrict__ k, const TW* __restrict__ bias,
            const float* __restrict__ ns, const float* __restrict__ nb, TX* __restrict__ out,
            Geo g, float eps) {
  constexpr bool BF16W = bf16_weights<TW>();
  constexpr int SX = sizeof(TX);
  constexpr int KS_MAX = BF16W ? MAX_CIN : 2 * MAX_CIN;
  extern __shared__ __align__(16) unsigned char smem[];
  int2 (*meta)[4] = reinterpret_cast<int2(*)[4]>(smem);  // [stage][input row]
  float* bias_s = reinterpret_cast<float*>(smem + META_BYTES);
  float* ns_s = bias_s + g.np;
  float* nb_s = ns_s + g.np;
  unsigned char* frags = smem + META_BYTES + 3 * g.np * sizeof(float);
  const int nks = BF16W ? g.cin : 2 * g.cin;
  unsigned char* stage = frags + (size_t)nks * g.nblk * 32 * 8;
  unsigned char* ostage = stage + (size_t)8 * g.row_bytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int cin = g.cin, cout = g.cout, k4 = 4 * cin;

  // ---- once per CTA: bias, LN affine and the weights in B-fragment order
  for (int i = tid; i < g.np; i += THREADS) {
    const bool in = i < cout;
    bias_s[i] = in ? to_f<TW>(bias[i]) : 0.0f;
    ns_s[i] = in ? ns[i] : 0.0f;
    nb_s[i] = in ? nb[i] : 0.0f;
  }
  for (int i = tid; i < nks * g.nblk * 32; i += THREADS) {
    const int l = i & 31, blk = (i >> 5) % g.nblk, ks = (i >> 5) / g.nblk;
    const int col = blk * 8 + (l >> 2), tt = l & 3;
    auto wv = [&](int kk) { return col < cout ? to_f<TW>(k[(size_t)kk * cout + col]) : 0.0f; };
    if constexpr (BF16W) {
      const int k0 = 16 * ks + 2 * tt;
      reinterpret_cast<uint2*>(frags)[i] =
          make_uint2(pack_bf16(wv(k0), wv(k0 + 1)), pack_bf16(wv(k0 + 8), wv(k0 + 9)));
    } else {
      const int k0 = 8 * ks + tt;
      reinterpret_cast<float2*>(frags)[i] = make_float2(wv(k0), wv(k0 + 4));
    }
  }

  // this lane's A-fragment k positions as (input row dy, element r of the
  // row's 4*Cin-long run of a pixel): k = dy * 4 Cin + r
  int apos[2 * KS_MAX];
#pragma unroll
  for (int j = 0; j < 2 * KS_MAX; ++j) {
    const int ks = j >> 1, half = j & 1;
    const int kk = BF16W ? 16 * ks + 8 * half + 2 * t : 8 * ks + 4 * half + t;
    const int dy = kk / k4;
    apos[j] = (dy << 16) | (kk - dy * k4);
  }

  // tile -> (image, output row, first output column)
  auto decode = [&](int tile, int& img, int& oy, int& ox0) {
    const int row = tile / g.tpr;
    ox0 = (tile - row * g.tpr) * TILE;
    img = row / g.ho;
    oy = row - img * g.ho;
  };

  // the four input row spans of `tile` into stage `buf`
  auto load = [&](int tile, int buf) {
    int img, oy, ox0;
    decode(tile, img, oy, ox0);
    const int count = min(4 * TILE, g.w - 4 * ox0) * cin;  // elements of a row span
#pragma unroll 1
    for (int dy = 0; dy < 4; ++dy) {
      const int yy = 4 * oy + dy;
      const int len = yy < g.h ? count : 0;
      const char* src = reinterpret_cast<const char*>(
          x + (((long long)img * g.h + min(yy, g.h - 1)) * g.w + 4 * ox0) * cin);
      const int m = (int)(reinterpret_cast<uintptr_t>(src) & 15);
      const char* base = src - m;
      const char* end = src + (size_t)len * SX;
      unsigned char* dst = stage + (size_t)(4 * buf + dy) * g.row_bytes;
      const int chunks = len ? (m + len * SX + 15) >> 4 : 0;
      for (int c = tid; c < chunks; c += THREADS) {
        const char* a = base + 16 * c;
        if (a >= src) {
          const long long left = end - a;
          cp_async16(dst + 16 * c, a, left < 16 ? (int)left : 16);
        } else {  // the head chunk: only the span's own bytes, element by element
          for (const char* e = src; e < a + 16 && e < end; e += SX) copy_elem<SX>(dst + (e - base), e);
        }
      }
      if (tid == 0) meta[buf][dy] = make_int2(m, len);
    }
  };

  const int grid = gridDim.x;  // tiles + 2 * grid < 2^31
  if ((int)blockIdx.x < g.tiles) load(blockIdx.x, 0);
  cp_async_commit();
  for (int it = 0, tile = blockIdx.x; tile < g.tiles; ++it, tile += grid) {
    const int buf = it & 1;
    if (tile + grid < g.tiles) load(tile + grid, buf ^ 1);  // the stage freed last tile
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed (this thread's)
    __syncthreads();     // ... everyone's; the weights are in place

    const unsigned char* sb = stage + (size_t)4 * buf * g.row_bytes;
    const int p_lo = 16 * warp + gq;  // this lane's pixels of the tile: p_lo, p_lo + 8
    // the staged input row of k position `pos` (its first element at `row`,
    // `len` elements) and the element of pixel p (+ off), 0 past the span
    auto row_of = [&](int pos, const unsigned char*& row, int& len) {
      const int dy = pos >> 16;
      const int2 md = meta[buf][dy];
      row = sb + dy * g.row_bytes + md.x;
      len = md.y;
    };
    auto av = [&](const unsigned char* row, int len, int pos, int p, int off) {
      const int e = 4 * p * cin + (pos & 0xffff) + off;
      return e < len ? to_f<TX>(*reinterpret_cast<const TX*>(row + e * SX)) : 0.0f;
    };

    float acc[NB][4];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      const int col = FULL ? blk * 8 + 2 * t : min(blk * 8 + 2 * t, g.np - 2);
      const float2 b = *reinterpret_cast<const float2*>(bias_s + col);
      acc[blk][0] = acc[blk][2] = b.x;
      acc[blk][1] = acc[blk][3] = b.y;
    }

#pragma unroll
    for (int ks = 0; ks < KS_MAX; ++ks) {
      if (ks >= nks) break;
      if constexpr (BF16W) {
        unsigned a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = apos[2 * ks + half];
          const unsigned char* row;
          int len;
          row_of(pos, row, len);
          a[2 * half] = pack_bf16(av(row, len, pos, p_lo, 0), av(row, len, pos, p_lo, 1));
          a[2 * half + 1] = pack_bf16(av(row, len, pos, p_lo + 8, 0), av(row, len, pos, p_lo + 8, 1));
        }
        const uint2* bf = reinterpret_cast<const uint2*>(frags) + (size_t)ks * g.nblk * 32 + lane;
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          if (FULL || blk < g.nblk) {
            const uint2 b = bf[blk * 32];
            mma_bf16(acc[blk], a, b.x, b.y);
          }
        }
      } else {
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = apos[2 * ks + half];
          const unsigned char* row;
          int len;
          row_of(pos, row, len);
          split(av(row, len, pos, p_lo, 0), ahi[2 * half], alo[2 * half]);
          split(av(row, len, pos, p_lo + 8, 0), ahi[2 * half + 1], alo[2 * half + 1]);
        }
        const float2* bf = reinterpret_cast<const float2*>(frags) + (size_t)ks * g.nblk * 32 + lane;
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          if (FULL || blk < g.nblk) {
            unsigned bh0, bl0, bh1, bl1;
            const float2 b = bf[blk * 32];
            split(b.x, bh0, bl0);
            split(b.y, bh1, bl1);
            // the step's products in a fresh accumulator, added to the sum
            // rounding to nearest (the tensor cores truncate each product
            // to their accumulator's exponent)
            float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_3xtf32(st, ahi, alo, bh0, bh1, bl0, bl1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[blk][e] += st[e];
          }
        }
      }
    }

    // ---- LN over the true Cout columns: rows gq (c0, c1) and gq + 8 (c2, c3)
    float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (FULL || (blk < g.nblk && blk * 8 + 2 * t + e < cout)) {
          s_lo += acc[blk][e];
          s_hi += acc[blk][2 + e];
        }
      }
    }
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
    const float mean_lo = s_lo / (float)cout, mean_hi = s_hi / (float)cout;
    float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (FULL || (blk < g.nblk && blk * 8 + 2 * t + e < cout)) {
          const float d_lo = acc[blk][e] - mean_lo, d_hi = acc[blk][2 + e] - mean_hi;
          q_lo += d_lo * d_lo;
          q_hi += d_hi * d_hi;
        }
      }
    }
    q_lo += __shfl_xor_sync(0xffffffffu, q_lo, 1);
    q_hi += __shfl_xor_sync(0xffffffffu, q_hi, 1);
    q_lo += __shfl_xor_sync(0xffffffffu, q_lo, 2);
    q_hi += __shfl_xor_sync(0xffffffffu, q_hi, 2);
    const float rstd_lo = 1.0f / sqrtf(q_lo / (float)cout + eps);
    const float rstd_hi = 1.0f / sqrtf(q_hi / (float)cout + eps);

    // ---- the warp's 16 pixels
    int img, oy, ox0;
    decode(tile, img, oy, ox0);
    const int rows = min(16, g.wo - ox0 - 16 * warp);
    const long long pix0 = ((long long)img * g.ho + oy) * g.wo + ox0 + 16 * warp;
    bool stored = false;
    if constexpr (SX == 4) {
      if (g.vec_out) {  // lane t ends with columns 8 blk + 4 (t >> 1) .. + 3 of row gq (t even) or gq + 8
        const bool odd = t & 1;
        const int row = gq + (odd ? 8 : 0);
        float* orow = reinterpret_cast<float*>(out) + (pix0 + row) * cout;
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          if (FULL || blk < g.nblk) {
            const int col = blk * 8 + 2 * t;
            const float2 sc = *reinterpret_cast<const float2*>(ns_s + col);
            const float2 sh = *reinterpret_cast<const float2*>(nb_s + col);
            const float y0 = (acc[blk][0] - mean_lo) * rstd_lo * sc.x + sh.x;
            const float y1 = (acc[blk][1] - mean_lo) * rstd_lo * sc.y + sh.y;
            const float y2 = (acc[blk][2] - mean_hi) * rstd_hi * sc.x + sh.x;
            const float y3 = (acc[blk][3] - mean_hi) * rstd_hi * sc.y + sh.y;
            const float r0 = __shfl_xor_sync(0xffffffffu, odd ? y0 : y2, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, odd ? y1 : y3, 1);
            const int vcol = blk * 8 + 4 * (t >> 1);
            if (row < rows && (FULL || vcol < cout))
              *reinterpret_cast<float4*>(orow + vcol) =
                  odd ? make_float4(r0, r1, y2, y3) : make_float4(y0, y1, r0, r1);
          }
        }
        stored = true;
      }
    }
    if (!stored && rows > 0) {  // staged at the span's offset mod 16
      char* dst = reinterpret_cast<char*>(out + pix0 * cout);
      const int m = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
      unsigned char* ob = ostage + (size_t)warp * g.out_bytes + m;
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = blk * 8 + 2 * t + e;
          if (FULL || (blk < g.nblk && col < cout)) {
            const float sc = ns_s[col], sh = nb_s[col];
            if (gq < rows)
              *reinterpret_cast<TX*>(ob + (gq * cout + col) * SX) =
                  from_f<TX>((acc[blk][e] - mean_lo) * rstd_lo * sc + sh);
            if (gq + 8 < rows)
              *reinterpret_cast<TX*>(ob + ((gq + 8) * cout + col) * SX) =
                  from_f<TX>((acc[blk][2 + e] - mean_hi) * rstd_hi * sc + sh);
          }
        }
      }
      __syncwarp();
      const unsigned char* obase = ob - m;
      char* base = dst - m;
      char* end = dst + (size_t)rows * cout * SX;
      const int chunks = (m + rows * cout * SX + 15) >> 4;
      for (int c = lane; c < chunks; c += 32) {
        char* a = base + 16 * c;
        if (a >= dst && a + 16 <= end) {
          *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(obase + 16 * c);
        } else {  // a ragged head or tail: the span's own elements
          for (char* e = a < dst ? dst : a; e < a + 16 && e < end; e += SX)
            copy_elem<SX>(e, obase + (e - base));
        }
      }
    }
    __syncthreads();  // the stage is free for the copies of the tile after next
  }
  cp_async_wait<0>();
}

template <typename TX, typename TW, int NB, bool FULL>
cudaError_t run(const Geo& g, const void* x, const void* k, const void* bias, const float* ns,
                const float* nb, void* out, float eps, cudaStream_t stream) {
  auto kernel = stem_kernel<TX, TW, NB, FULL>;
  const size_t smem = smem_bytes<TW>(g);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // as many CTAs as an SM holds: each walks its tiles
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int blocks = g.tiles < sms * per_sm ? g.tiles : sms * per_sm;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(k), static_cast<const TW*>(bias), ns, nb,
      static_cast<TX*>(out), g, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* k, const void* bias, const float* ns,
                   const float* nb, void* out, int n, int h, int w, int cin, int cout,
                   float eps, cudaStream_t stream) {
  Geo g;
  g.h = h, g.w = w, g.cin = cin, g.cout = cout;
  g.ho = (h + 3) / 4, g.wo = (w + 3) / 4;
  g.tpr = (g.wo + TILE - 1) / TILE;
  const long long tiles = (long long)n * g.ho * g.tpr;
  if (tiles >= (1LL << 30)) return cudaErrorInvalidValue;  // and tiles + 2 * grid < 2^31
  g.tiles = (int)tiles;
  g.nblk = (cout + 7) / 8;
  g.np = 8 * g.nblk;
  g.row_bytes = 4 * TILE * cin * (int)sizeof(TX) + 16;
  g.vec_out = sizeof(TX) == 4 && cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.out_bytes = g.vec_out ? 0 : 16 * cout * (int)sizeof(TX) + 16;
  // the tower's two stems (ConvNeXt-Tiny's 96, the micro tower's 8) without
  // column guards; any other Cout <= 256 guarded
  if (cout == 8) return run<TX, TW, 1, true>(g, x, k, bias, ns, nb, out, eps, stream);
  if (cout == 96) return run<TX, TW, 12, true>(g, x, k, bias, ns, nb, out, eps, stream);
  if (g.nblk <= 4) return run<TX, TW, 4, false>(g, x, k, bias, ns, nb, out, eps, stream);
  if (g.nblk <= 12) return run<TX, TW, 12, false>(g, x, k, bias, ns, nb, out, eps, stream);
  return run<TX, TW, MAX_COUT / 8, false>(g, x, k, bias, ns, nb, out, eps, stream);
}

}  // namespace

extern "C" {

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.  Cin <= 4, Cout <= 256.
// Returns a cudaError_t.
int mmg_fused_stem(int x_dtype, int w_dtype, const void* x, const void* k, const void* bias,
                   const float* ns, const float* nb, void* out, int n, int h, int w, int cin,
                   int cout, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin > MAX_CIN || cout > MAX_COUT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, bf16>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<bf16, float>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<bf16, bf16>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
