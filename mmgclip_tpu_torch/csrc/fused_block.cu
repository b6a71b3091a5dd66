// One whole ConvNeXt block, for sm_90a:
//
//     out = x + gamma * pw2(GELU(pw1(LN(dwconv7x7(x) + dw_bias))))
//
// Replaces the Pallas TPU kernels of mmgclip_tpu/ops/fused_block.py
// (`_fused_call` / `_kernel`, and the row-banded `_fused_call_banded` /
// `_kernel_banded` with its `_pad_to_band` padding): on this card one grid
// covers all three TPU routes, because the front half stages each tile's
// 7x7 halo with a bounds check (SAME padding) instead of staging a whole
// image or band in fast memory.
//
// Layout: x / out [n, H, W, C] (NHWC, contiguous); dwk [7, 7, 1, C] (HWIO);
// w1 [C, 4C]; w2 [4C, C]; dwb, b2, gamma [C]; b1 [4C]; the LayerNorm affine
// ns / nb [C] is always fp32.  T is float or __nv_bfloat16.
//
// The fp / bf16 block is two launches on one stream (mmg_fused_block):
//   (a) the depthwise 7x7 halo tile of depthwise_tile.cuh with an fp32
//       output into a workspace y [n*H*W, C] that the caller allocates: the
//       49 taps and the bias sum in fp32, the JAX kernel's hand-off into LN;
//   (b) ln_mlp (below): LN, pw1, GELU, pw2, layer scale and residual on the
//       tensor cores, the 4C intermediate kept on chip.
// The rounding points are the JAX kernel's: LN in fp32 over C (eps 1e-6,
// two passes) rounded to T before pw1; pw1 summed in fp32, then b1 and GELU
// (erf or tanh), rounded to T before pw2; pw2 summed in fp32, then b2, the
// layer scale and the residual, one store in T.
//
// What bounds it: the two pointwise products are 16*C^2 of the block's
// 16*C^2 + 98*C operations per pixel against 2*C*sizeof(T) bytes per pixel
// moved (plus the weights once), so operations at every ConvNeXt-Tiny stage
// (bf16 on the tensor cores; fp32 as three TF32 products each).  The fp32
// hand-off of (a) adds 8 bytes per element, the price of reusing the halo
// tile.
//
// ln_mlp's design.  A CTA owns BM = 16 * WM consecutive pixels of the
// flattened n*H*W range and all C channels, with WM x WN warps: warp (wm, wn)
// owns rows [16 wm, 16 wm + 16) (the mma's M) and, of pw2's output, columns
// [wn NW, wn NW + NW) with NW <= 96, so its pw2 sums are 16 x NW fp32 in
// registers (48 a thread).  WN grows with C (C = 96: 1 warp across, C = 768:
// 8); WM is the largest of 16 / WN, 16 / (2 WN), ... whose shared memory
// fits (BM = 256, 128, 64, 32 rows at C = 96, 192, 384, 768 in bf16).
//   (i)   LN: one warp per row reads the fp32 row of y (8 rows at once up
//         to C = 192, 2 up to C = 768), two-pass statistics, and writes the
//         row rounded to T into the A tile [BM, Cp] (Cp = C rounded up to
//         16, zero-filled); rows past n*H*W are zeros.
//   (ii)  the 4C hidden units in chunks of HN = HW * WN (HW = 32 or 64 per
//         warp): pw1 = A . W1[:, chunk] (warp (wm, wn) computes HW of the
//         chunk's columns for its rows), b1 and GELU on the fragment,
//         rounded to T into the H tile [BM, HN]; then pw2: O += H .
//         W2[chunk, :].  The weights stream through shared memory as tiles
//         of K rows (W1 [KS1, HN], W2 [KS2, Cp]) by 16-byte cp.async
//         (zero-filled past C and 4C), as many stages as shared memory
//         holds, one barrier per tile; the A tile stays put.
//   (iii) epilogue: the O fragments go through an fp32 O tile in shared
//         memory, and x + gamma * (O + b2) is stored from it by 4-vectors.
// Where few row tiles would leave SMs idle (C = 768: 52 tiles of 32 rows on
// 132 SMs), a cluster of up to 8 CTAs shares a row tile, each CTA with its
// own hidden chunks (pick_split), and the epilogue sums the CTAs' partial O
// tiles through distributed shared memory in a fixed order.
// bf16 runs mma.sync m16n8k16 (fp32 accumulate) with A and H fragments by
// ldmatrix and the K-major weight fragments by ldmatrix.trans, as
// flash_attention.cu reads V; fp32 runs the same tiles on m16n8k8 TF32 in
// the three-pass split of flash_attention.cu (plain 32-bit fragment loads).
// Rows are padded so that fragment reads are free of bank conflicts.  No
// atomics: two launches on the same input give the same bits.
//
// Measured on an H100 80GB HBM3 (chip_smoke.py phase 11; block_sweep.py
// times variants of this file, PERF.md): far from its operation bound at
// every stage.  Neither the products nor the weight stream alone holds it,
// and at C = 96 the GELU (erf) and the LN take a large share, every warp of
// a CTA meeting at each weight tile's barrier.  TMA bulk copies of the
// weight rows (an mbarrier a stage) measured slower than cp.async, and
// smaller tiles in more stages too.

// The int8 block (mmg_fused_block_int8, below) keeps its own one-kernel
// design with __dp4a products.

#include "common.cuh"
#include "depthwise_tile.cuh"

#include <algorithm>

#include <cooperative_groups.h>

namespace {

using namespace mmg;

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int THREADS = 256;  // the int8 kernel's

// (a) of the int8 kernel: the 49 depthwise taps of pixel `pix`, channel `ch`,
// accumulated in fp32 (out-of-image taps skipped: SAME zero padding), plus
// the bias
template <typename T>
__device__ __forceinline__ float dwconv_at(const T* __restrict__ x, const T* __restrict__ dwk,
                                           const T* __restrict__ dwb, long long pix, int ch,
                                           int h, int w, int c) {
  const long long hw = (long long)h * w;
  const long long img = pix / hw;
  const long long rem = pix - img * hw;
  const int py = (int)(rem / w);
  const int px = (int)(rem - (long long)py * w);
  const T* xb = x + img * hw * c + ch;
  float s = 0.0f;
  for (int ky = 0; ky < KS; ++ky) {
    const int yy = py + ky - HALO;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int kx = 0; kx < KS; ++kx) {
      const int xx = px + kx - HALO;
      if (xx < 0 || xx >= w) continue;
      s += to_f<T>(xb[((long long)yy * w + xx) * c]) * to_f<T>(dwk[(ky * KS + kx) * c + ch]);
    }
  }
  return s + to_f<T>(dwb[ch]);
}

// ---------------------------------------------------------------------------
// ln_mlp: the back half of the fp / bf16 block on the tensor cores.

constexpr int MLP_THREADS = 512;   // threads of a CTA at most (16 warps)
constexpr int OUT_BLOCKS = 12;     // 8-column blocks of pw2's output a warp holds (96 columns)
constexpr int MAX_STAGES = 8;      // weight tiles in flight at most

// Per type: 8-column blocks of the hidden chunk a warp computes (all of them
// independent mma chains); the mma's K step; the padding of the A and H rows
// (16 bytes in bf16, 4 words in fp32); the bytes a weight stage holds at
// least (fewer, larger tiles: one barrier per tile)
template <typename T> __host__ __device__ constexpr int hid_blocks() { return sizeof(T) == 2 ? 8 : 4; }
template <typename T> __host__ __device__ constexpr int kstep() { return sizeof(T) == 2 ? 16 : 8; }
template <typename T> __host__ __device__ constexpr int act_pad() { return sizeof(T) == 2 ? 8 : 4; }
template <typename T> constexpr int stage_bytes() { return sizeof(T) == 2 ? 65536 : 32768; }

struct MlpPlan {
  int cp;          // C rounded up to 16
  int wn, wm;      // warps across pw2's output columns / across the rows
  int nw;          // output columns per warp (a multiple of 16, <= 96)
  int hw, hn;      // hidden units per warp and per chunk (hn = hw * wn)
  int ks1, ks2;    // rows of a W1 tile (k of pw1) and of a W2 tile (k of pw2)
  int n1, n2;      // W1 and W2 tiles per chunk
  int chunks;      // hidden chunks: ceil(4C / hn)
  int stages;      // weight tiles in flight (2..MAX_STAGES)
  int split;       // CTAs of a cluster that share a row tile, each with its own hidden chunks
  int a_stride, h_stride, w1_stride, w2_stride, stage_elems;  // in elements
  size_t smem;     // bytes
};

// The tile plan of C, or wm = 0 when no plan fits in ``max_smem`` bytes.
// Rows per CTA: the most that fit (the fewest weight reads per row).
template <typename T>
MlpPlan plan_mlp(int c, int max_smem) {
  MlpPlan p{};
  p.split = 1;
  p.cp = (c + 15) / 16 * 16;
  p.wn = (p.cp + 95) / 96;
  p.nw = ((p.cp + p.wn - 1) / p.wn + 15) / 16 * 16;
  p.hw = hid_blocks<T>() * 8;
  p.hn = p.hw * p.wn;
  p.a_stride = p.cp + act_pad<T>();
  p.h_stride = p.hn + act_pad<T>();
  p.w1_stride = p.hn + 8;
  p.w2_stride = p.cp + 8;
  const int cap = std::max(std::max(16 * p.w1_stride, 16 * p.w2_stride),
                           stage_bytes<T>() / (int)sizeof(T));
  p.ks1 = std::min(p.cp, cap / p.w1_stride / 16 * 16);
  p.ks2 = std::min(p.hn, cap / p.w2_stride / 16 * 16);
  p.stage_elems = std::max(p.ks1 * p.w1_stride, p.ks2 * p.w2_stride);
  p.n1 = (p.cp + p.ks1 - 1) / p.ks1;
  p.n2 = (p.hn + p.ks2 - 1) / p.ks2;
  p.chunks = (4 * c + p.hn - 1) / p.hn;
  const int max_warps = MLP_THREADS / 32;
  if (p.wn > max_warps) return p;
  for (int wm = max_warps / p.wn; wm >= 1; wm /= 2) {
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      // the weight stages, the A and the H tile; the fp32 O tile [bm, C] of
      // the epilogue reuses them
      const size_t bytes = std::max(((size_t)16 * wm * (p.a_stride + p.h_stride) +
                                     (size_t)stages * p.stage_elems) * sizeof(T),
                                    (size_t)16 * wm * (c + 4) * sizeof(float));
      if (bytes <= (size_t)max_smem) {
        p.wm = wm;
        p.stages = stages;
        p.smem = bytes;
        return p;
      }
    }
  }
  return p;
}

// LN of ROWS rows of y at once (rows r, r + step, ...), a lane holding the
// channel pairs 2 lane + 64 i, i < PAIRS, of each (C <= 64 * PAIRS): one
// round trip to device memory for all of them, 8-byte loads, and the LN
// affine read once.  Rows past bm are skipped, rows past n*H*W are zeros.
template <typename T, int ROWS, int PAIRS>
__device__ __forceinline__ void ln_rows(T* As, int a_stride, int cp, int r, int step, int bm,
                                        long long pix0, long long total, const float* __restrict__ y,
                                        const float* __restrict__ ns, const float* __restrict__ nb,
                                        int c, float eps) {
  const int lane = threadIdx.x & 31;
  float2 v[ROWS][PAIRS], scale[PAIRS], shift[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int ch = 2 * lane + 64 * i;  // C % 4 == 0: a pair lies wholly inside C or past it
    scale[i] = ch < c ? *reinterpret_cast<const float2*>(ns + ch) : make_float2(0.0f, 0.0f);
    shift[i] = ch < c ? *reinterpret_cast<const float2*>(nb + ch) : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const long long pix = pix0 + r + q * step;
    const bool live = r + q * step < bm && pix < total;
    const float* row = y + (live ? pix : 0) * c;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int ch = 2 * lane + 64 * i;
      v[q][i] = live && ch < c ? *reinterpret_cast<const float2*>(row + ch) : make_float2(0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int rr = r + q * step;
    if (rr >= bm) break;
    T* arow = As + (size_t)rr * a_stride;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) sum += v[q][i].x + v[q][i].y;
    const float mean = warp_sum(sum) / (float)c;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const float dx = v[q][i].x - mean, dy = v[q][i].y - mean;
      if (2 * lane + 64 * i < c) sq += dx * dx + dy * dy;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)c + eps);
    const bool live = pix0 + rr < total;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int ch = 2 * lane + 64 * i;
      if (ch < cp) {
        const bool ok = live && ch < c;
        const float a = ok ? (v[q][i].x - mean) * rstd * scale[i].x + shift[i].x : 0.0f;
        const float b = ok ? (v[q][i].y - mean) * rstd * scale[i].y + shift[i].y : 0.0f;
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<unsigned*>(arow + ch) = pack_bf16(a, b);
        } else {
          *reinterpret_cast<float2*>(arow + ch) = make_float2(a, b);
        }
      }
    }
    for (int ch = 2 * lane + 64 * PAIRS; ch < cp; ch += 64) {
      arow[ch] = from_f<T>(0.0f);
      arow[ch + 1] = from_f<T>(0.0f);
    }
  }
}

// four consecutive values of T (8- or 16-byte aligned) as / from a float4
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
  uint2 raw;
  raw.x = pack_bf16(v.x, v.y);
  raw.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

// (iii) the epilogue: each warp writes its O fragments (fp32) into the O
// tile [bm, C] (rows padded by 4) in shared memory, over the spent weight stages, A and H
// tiles; then the CTA reads the tile back by float4 groups, with x, b2 and
// gamma as 4-vectors, and stores x + gamma * (O + b2) in T (coalesced).  In
// a split row tile, each CTA of the cluster holds its partial O, and CTA
// `rank` sums every CTA's partial for its share of the groups through
// distributed shared memory, in the fixed order 0, 1, ..., parts - 1 (the
// same bits on every launch).
template <typename T>
__device__ __forceinline__ void store_tile(unsigned char* smem_raw, const float (&acc)[OUT_BLOCKS][4],
                                           int bm, int r0, int ocol0, int oblocks, int rank,
                                           int parts, long long pix0, long long total, int c,
                                           const T* __restrict__ x, const T* __restrict__ b2,
                                           const T* __restrict__ gamma, T* __restrict__ out) {
  namespace cg = cooperative_groups;
  float* part = reinterpret_cast<float*>(smem_raw);  // [bm][C + 4]: the fragment rows 4 banks apart
  const int ostride = c + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp is done with the stages, the A and the H tile
#pragma unroll
  for (int blk = 0; blk < OUT_BLOCKS; ++blk) {
    const int n = ocol0 + blk * 8 + 2 * t;
    if (blk < oblocks && n < c) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(part + (size_t)(r0 + g + 8 * half) * ostride + n) =
            make_float2(acc[blk][2 * half], acc[blk][2 * half + 1]);
    }
  }
  if (parts > 1) {
    cg::this_cluster().sync();  // every partial written and visible across the cluster
  } else {
    __syncthreads();
  }
  const int groups = bm * c / 4;
  for (int i = rank * blockDim.x + threadIdx.x; i < groups; i += parts * blockDim.x) {
    const int row = 4 * i / c, col = 4 * i - row * c;
    const long long pix = pix0 + row;
    if (pix >= total) continue;
    const size_t at_tile = (size_t)row * ostride + col;
    float4 o;
    if (parts == 1) {
      o = *reinterpret_cast<const float4*>(part + at_tile);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      o = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + at_tile);
      for (int q = 1; q < parts; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + at_tile);
        o.x += v.x; o.y += v.y; o.z += v.z; o.w += v.w;
      }
    }
    const long long at = pix * c + col;
    const float4 xv = load4(x + at), bv = load4(b2 + col), gv = load4(gamma + col);
    store4(out + at, make_float4(xv.x + (o.x + bv.x) * gv.x, xv.y + (o.y + bv.y) * gv.y,
                                 xv.z + (o.z + bv.z) * gv.z, xv.w + (o.w + bv.w) * gv.w));
  }
  if (parts > 1) cg::this_cluster().sync();  // no CTA leaves while another still reads its partial
}

template <typename T>
__global__ void __launch_bounds__(MLP_THREADS, 1)
ln_mlp_kernel(const float* __restrict__ y, const T* __restrict__ x, const float* __restrict__ ns,
              const float* __restrict__ nb, const T* __restrict__ w1, const T* __restrict__ b1,
              const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ gamma,
              T* __restrict__ out, long long total, int c, float eps, int gelu_tanh, MlpPlan p,
              int vec1, int vec2) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int HB = hid_blocks<T>();
  constexpr int KSTEP = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);                 // [stages][stage_elems]
  const int bm = 16 * p.wm;
  T* As = stages + (size_t)p.stages * p.stage_elems;           // [bm][a_stride]
  T* Hs = As + (size_t)bm * p.a_stride;                        // [bm][h_stride]

  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / p.wn, wn = warp - wm * p.wn;
  const int r0 = 16 * wm;                                       // this warp's 16 rows
  // with split > 1, a cluster of split CTAs owns the row tile and CTA `rank`
  // the hidden chunks [chunk0, chunk0 + my_chunks)
  const int rank = p.split > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const long long pix0 = (long long)((blockIdx.x - rank) / p.split) * bm;
  const int chunk0 = rank * (p.chunks / p.split) + min(rank, p.chunks % p.split);
  const int my_chunks = p.chunks / p.split + (rank < p.chunks % p.split ? 1 : 0);
  const int c4 = 4 * c;
  const int per_chunk = p.n1 + p.n2;
  const int tiles = my_chunks * per_chunk;
  const int hcol0 = wn * p.hw, hblocks = p.hw / 8;
  const int ocol0 = wn * p.nw, oblocks = max(0, min(p.nw, p.cp - ocol0)) / 8;
  // ldmatrix lanes: A / H rows and columns; .trans rows (k) and columns (n)
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;

  auto stage_of = [&](int tile) { return stages + (size_t)(tile % p.stages) * p.stage_elems; };

  // Tile order per chunk: n1 W1 tiles [KS1 k-rows, the chunk's HN columns],
  // then n2 W2 tiles [KS2 of the chunk's hidden rows, Cp columns].
  auto load = [&](int tile) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
    T* buf = stage_of(tile);
    const int s = tile % per_chunk, j0 = (chunk0 + tile / per_chunk) * p.hn;
    if (s < p.n1) {
      const int k0 = s * p.ks1, rows = min(p.ks1, p.cp - k0), per_row = p.hn / E;
      for (int i = threadIdx.x; i < rows * per_row; i += nthreads) {
        const int r = i / per_row, e = (i - r * per_row) * E;
        const int k = k0 + r, j = j0 + e;
        T* dst = buf + r * p.w1_stride + e;
        if (vec1) {  // 4C % E == 0: a copy lies wholly inside 4C or past it
          const bool ok = k < c && j < c4;
          cp_async16(dst, ok ? w1 + (long long)k * c4 + j : w1, ok ? 16 : 0);
        } else {
          for (int q = 0; q < E; ++q)
            dst[q] = (k < c && j + q < c4) ? w1[(long long)k * c4 + j + q] : from_f<T>(0.0f);
        }
      }
    } else {
      const int k0 = (s - p.n1) * p.ks2, rows = min(p.ks2, p.hn - k0), per_row = p.cp / E;
      for (int i = threadIdx.x; i < rows * per_row; i += nthreads) {
        const int r = i / per_row, e = (i - r * per_row) * E;
        const int j = j0 + k0 + r;
        T* dst = buf + r * p.w2_stride + e;
        if (vec2) {  // C % E == 0
          const bool ok = j < c4 && e < c;
          cp_async16(dst, ok ? w2 + (long long)j * c + e : w2, ok ? 16 : 0);
        } else {
          for (int q = 0; q < E; ++q)
            dst[q] = (j < c4 && e + q < c) ? w2[(long long)j * c + e + q] : from_f<T>(0.0f);
        }
      }
    }
  };

  for (int i = 0; i < p.stages - 1; ++i) {  // the first tiles' copies run under the LN
    if (i < tiles) load(i);
    cp_async_commit();
  }

  // (i) LN over C in fp32, one warp per row, rounded to T into the A tile:
  // several rows at once from registers up to C = 768, else warp_row_stats's
  // three passes over y
  if (c <= 64 * 3) {
    for (int r = warp; r < bm; r += 8 * nwarps)
      ln_rows<T, 8, 3>(As, p.a_stride, p.cp, r, nwarps, bm, pix0, total, y, ns, nb, c, eps);
  } else if (c <= 64 * 12) {
    for (int r = warp; r < bm; r += 2 * nwarps)
      ln_rows<T, 2, 12>(As, p.a_stride, p.cp, r, nwarps, bm, pix0, total, y, ns, nb, c, eps);
  } else {
    for (int r = warp; r < bm; r += nwarps) {
      const long long pix = pix0 + r;
      T* arow_ptr = As + (size_t)r * p.a_stride;
      if (pix < total) {
        const float* row = y + pix * c;
        const float2 st = warp_row_stats(row, c, eps);
        for (int ch = lane; ch < p.cp; ch += 32)
          arow_ptr[ch] = ch < c ? from_f<T>((row[ch] - st.x) * st.y * ns[ch] + nb[ch])
                                : from_f<T>(0.0f);
      } else {
        for (int ch = lane; ch < p.cp; ch += 32) arow_ptr[ch] = from_f<T>(0.0f);
      }
    }
  }

  float acc1[HB][4], acc[OUT_BLOCKS][4];
#pragma unroll
  for (int i = 0; i < HB; ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < OUT_BLOCKS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  // (ii) the hidden chunks, one weight tile per step
  for (int tile = 0; tile < tiles; ++tile) {
    switch (p.stages) {  // this thread's copies of the tile have landed
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      case 4: cp_async_wait<2>(); break;
      case 5: cp_async_wait<3>(); break;
      case 6: cp_async_wait<4>(); break;
      case 7: cp_async_wait<5>(); break;
      default: cp_async_wait<6>(); break;
    }
    __syncthreads();  // tile landed for all; the A / H writes are visible; the oldest stage is free
    if (tile + p.stages - 1 < tiles) load(tile + p.stages - 1);
    cp_async_commit();
    const T* buf = stage_of(tile);
    const int s = tile % per_chunk;
    if (s < p.n1) {
      // pw1: acc1 += A[rows, k0 : k0 + rows] . W1 tile
      const int k0 = s * p.ks1, rows = min(p.ks1, p.cp - k0);
      for (int kk = 0; kk < rows; kk += KSTEP) {
        if constexpr (BF16) {
          unsigned a[4];
          ldmatrix_x4(a, As + (size_t)(r0 + arow) * p.a_stride + k0 + kk + acol);
#pragma unroll
          for (int blk = 0; blk < HB; blk += 2) {
            if (blk < hblocks) {
              unsigned b[4];
              ldmatrix_x4_trans(b, buf + (kk + vkey) * p.w1_stride + hcol0 + blk * 8 + vcol);
              mma_bf16(acc1[blk], a, b[0], b[1]);
              mma_bf16(acc1[blk + 1], a, b[2], b[3]);
            }
          }
        } else {
          const float* ar = As + (size_t)(r0 + g) * p.a_stride + k0 + kk + t;
          unsigned ahi[4], alo[4];
          split(ar[0], ahi[0], alo[0]);
          split(ar[8 * p.a_stride], ahi[1], alo[1]);
          split(ar[4], ahi[2], alo[2]);
          split(ar[8 * p.a_stride + 4], ahi[3], alo[3]);
#pragma unroll
          for (int blk = 0; blk < HB; ++blk) {
            if (blk < hblocks) {
              const float* br = buf + (kk + t) * p.w1_stride + hcol0 + blk * 8 + g;
              unsigned bh0, bl0, bh1, bl1;
              split(br[0], bh0, bl0);
              split(br[4 * p.w1_stride], bh1, bl1);
              mma_3xtf32(acc1[blk], ahi, alo, bh0, bh1, bl0, bl1);
            }
          }
        }
      }
      if (s == p.n1 - 1) {
        // + b1, GELU, rounded to T into the H tile (hidden units past 4C are 0)
        const int j0 = (chunk0 + tile / per_chunk) * p.hn;
#pragma unroll
        for (int blk = 0; blk < HB; ++blk) {
          if (blk < hblocks) {
            const int col = hcol0 + blk * 8 + 2 * t, j = j0 + col;
            const bool ok = j < c4;  // j even and 4C % 4 == 0: j + 1 < 4C too
            const float bj0 = ok ? to_f<T>(b1[j]) : 0.0f, bj1 = ok ? to_f<T>(b1[j + 1]) : 0.0f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float h0 = ok ? round_to<T>(gelu(acc1[blk][2 * half] + bj0, gelu_tanh)) : 0.0f;
              const float h1 = ok ? round_to<T>(gelu(acc1[blk][2 * half + 1] + bj1, gelu_tanh)) : 0.0f;
              T* dst = Hs + (size_t)(r0 + g + 8 * half) * p.h_stride + col;
              if constexpr (BF16) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(h0, h1);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(h0, h1);
              }
            }
            acc1[blk][0] = acc1[blk][1] = acc1[blk][2] = acc1[blk][3] = 0.0f;
          }
        }
      }
    } else {
      // pw2: acc += H[rows, k0 : k0 + rows] . W2 tile
      const int k0 = (s - p.n1) * p.ks2, rows = min(p.ks2, p.hn - k0);
      for (int kk = 0; kk < rows; kk += KSTEP) {
        if constexpr (BF16) {
          unsigned a[4];
          ldmatrix_x4(a, Hs + (size_t)(r0 + arow) * p.h_stride + k0 + kk + acol);
#pragma unroll
          for (int blk = 0; blk < OUT_BLOCKS; blk += 2) {
            if (blk < oblocks) {
              unsigned b[4];
              ldmatrix_x4_trans(b, buf + (kk + vkey) * p.w2_stride + ocol0 + blk * 8 + vcol);
              mma_bf16(acc[blk], a, b[0], b[1]);
              mma_bf16(acc[blk + 1], a, b[2], b[3]);
            }
          }
        } else {
          const float* hr = Hs + (size_t)(r0 + g) * p.h_stride + k0 + kk + t;
          unsigned ahi[4], alo[4];
          split(hr[0], ahi[0], alo[0]);
          split(hr[8 * p.h_stride], ahi[1], alo[1]);
          split(hr[4], ahi[2], alo[2]);
          split(hr[8 * p.h_stride + 4], ahi[3], alo[3]);
#pragma unroll
          for (int blk = 0; blk < OUT_BLOCKS; ++blk) {
            if (blk < oblocks) {
              const float* br = buf + (kk + t) * p.w2_stride + ocol0 + blk * 8 + g;
              unsigned bh0, bl0, bh1, bl1;
              split(br[0], bh0, bl0);
              split(br[4 * p.w2_stride], bh1, bl1);
              mma_3xtf32(acc[blk], ahi, alo, bh0, bh1, bl0, bl1);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  store_tile<T>(smem_raw, acc, bm, r0, ocol0, oblocks, rank, p.split, pix0, total, c, x, b2, gamma,
                out);
}

// CTAs per row tile: the split (1..8) with the least modelled time, counted
// in chunk-times of one CTA a SM: waves of CTAs times the chunks of the
// busiest CTA plus one chunk-time for its LN and epilogue.  A split shares
// the weight stream of a row tile among several SMs, which pays where few
// row tiles leave SMs idle (C = 768: 52 tiles of 32 rows on 132 SMs).
// Ties keep the smaller split.
inline int pick_split(long long row_tiles, int chunks, int sms) {
  int best = 1;
  long long best_cost = 0;
  for (int s = 1; s <= std::min(8, chunks); ++s) {
    const long long waves = (row_tiles * s + sms - 1) / sms;
    const long long cost = waves * ((chunks + s - 1) / s + 1);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
cudaError_t launch_ln_mlp(const float* y, const void* x, const float* ns, const float* nb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* gamma, void* out, long long total, int c, float eps,
                          int gelu_tanh, cudaStream_t stream) {
  auto kernel = ln_mlp_kernel<T>;
  int max_smem = 0;
  const cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  MlpPlan p = plan_mlp<T>(c, max_smem);
  if (p.wm == 0) return cudaErrorInvalidValue;
  const long long bm = 16LL * p.wm;
  const long long row_tiles = (total + bm - 1) / bm;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  p.split = pick_split(row_tiles, p.chunks, sms);
  const long long blocks = row_tiles * p.split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec1 = reinterpret_cast<uintptr_t>(w1) % 16 == 0;  // rows of 4C elements: 16-byte multiples
  const bool vec2 = reinterpret_cast<uintptr_t>(w2) % 16 == 0 && (c * sizeof(T)) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(32 * p.wm * p.wn);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, y, static_cast<const T*>(x), ns, nb,
                            static_cast<const T*>(w1), static_cast<const T*>(b1),
                            static_cast<const T*>(w2), static_cast<const T*>(b2),
                            static_cast<const T*>(gamma), static_cast<T*>(out), total, c, eps,
                            gelu_tanh, p, vec1 ? 1 : 0, vec2 ? 1 : 0);
}

// C's largest value: WN = ceil(Cp / 96) warps across must fit in one CTA
constexpr int MAX_C = 96 * MLP_THREADS / 32;

bool block_args_ok(int n, int h, int w, int c) {
  return n > 0 && h > 0 && w > 0 && c > 0 && c % 4 == 0 && c <= MAX_C;
}

// ---------------------------------------------------------------------------
// The int8 block (replaces `_fused_call_int8` of mmgclip_tpu/ops/fused_block.py
// and the `quant=True` route of `_fused_call_banded`).
//
// Same block, with both pointwise products in int8 and exact int32 sums:
//   * weights are quantised by the wrapper, per output channel
//     (`int8_quantize(w, axis=0)`: scale max(amax, 1e-8) / 127, round half to
//     even, clip to +-127) and packed four input rows to an int32 word:
//     w1p [C/4][4C], w2p [C][C] (word (q, j) holds rows 4q..4q+3 of column j);
//   * activations are quantised here with ONE SCALE PER PIXEL: the LN output
//     over its C channels before pw1, the GELU output over its 4C hidden
//     units before pw2.  Scale = max(amax, 1e-8) * float(1/127) (the JAX
//     kernel's formula), q = clip(rint(v / scale), -127, 127).  The partition
//     depends on the tensor's shape alone, never on the launch, so the plain
//     version (ops/fused_block.py::plain_convnext_block_int8) computes the same
//     one; it also keeps masked (bucketed) encodes equal to exact-shape ones,
//     since pad pixels never share a scale with real ones.  (The JAX kernel's
//     scale is per row chunk, which follows its VMEM tiling.)
//   * products run as __dp4a (four int8 products into int32), dequantised by
//     the product of the two scales; no rounding to T inside the block (the
//     JAX int8 kernel keeps the LN and GELU outputs in fp32).
// A CTA owns P pixels; the GELU output of its P pixels is held whole in
// shared memory ([P][4C] fp32, 12 KB per pixel at C = 768) because its scale
// needs the whole row, so P shrinks with C.  What bounds it: 16*C^2 int8
// operations per pixel (dp4a, not the tensor cores) against 2*C*sizeof(T)
// bytes, so operations.

constexpr int PT8 = 8;  // pixels per thread item in the int8 products

size_t smem_bytes_int8(int p, int c) {
  // hid [P][4C] fp32 (also the LN rows [P][C] before pw1), yq [P][C] and
  // hq [P][4C] int8, one scale per pixel for each product
  return (size_t)p * 16 * c + (size_t)p * c + (size_t)p * 4 * c + 2 * (size_t)p * sizeof(float);
}

// quantise one row of n values (a whole warp): -> scale, q[] in int8
__device__ __forceinline__ float warp_quantize_row(const float* row, int8_t* q, int n) {
  const int lane = threadIdx.x & 31;
  float amax = 0.0f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(row[i]));
  const float scale = fmaxf(warp_max(amax), 1e-8f) * (1.0f / 127.0f);
  for (int i = lane; i < n; i += 32)
    q[i] = (int8_t)fminf(fmaxf(rintf(row[i] / scale), -127.0f), 127.0f);
  return scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_block_int8_kernel(const T* __restrict__ x, const T* __restrict__ dwk,
                        const T* __restrict__ dwb, const float* __restrict__ ns,
                        const float* __restrict__ nb, const int* __restrict__ w1p,
                        const float* __restrict__ ws1, const T* __restrict__ b1,
                        const int* __restrict__ w2p, const float* __restrict__ ws2,
                        const T* __restrict__ b2, const T* __restrict__ gamma,
                        T* __restrict__ out, int n, int h, int w, int c, int p_tile, float eps,
                        int gelu_tanh) {
  extern __shared__ __align__(16) float smem[];
  const int c4 = 4 * c;
  float* hid = smem;                                       // [P][4C]; [P][C] LN rows first
  int8_t* yq = reinterpret_cast<int8_t*>(hid + p_tile * c4);  // [P][C]
  int8_t* hq = yq + p_tile * c;                             // [P][4C]
  float* s1 = reinterpret_cast<float*>(hq + p_tile * c4);   // [P]
  float* s2 = s1 + p_tile;                                  // [P]

  const long long total = (long long)n * h * w;
  const long long pix0 = (long long)blockIdx.x * p_tile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int groups = p_tile / PT8;

  // (a) depthwise 7x7 + bias into the LN rows
  for (int idx = tid; idx < p_tile * c; idx += THREADS) {
    const int p = idx / c;
    const int ch = idx - p * c;
    const long long pix = pix0 + p;
    hid[idx] = pix < total ? dwconv_at<T>(x, dwk, dwb, pix, ch, h, w, c) : 0.0f;
  }
  __syncthreads();

  // (b) LN over C in fp32, then the per-pixel int8 quantisation of pw1's input
  for (int p = warp; p < p_tile; p += THREADS / 32) {
    float* row = hid + p * c;
    const float2 st = warp_row_stats(row, c, eps);
    for (int ch = lane; ch < c; ch += 32) row[ch] = (row[ch] - st.x) * st.y * ns[ch] + nb[ch];
    __syncwarp();
    const float scale = warp_quantize_row(row, yq + p * c, c);
    if (lane == 0) s1[p] = scale;
  }
  __syncthreads();

  // (c) pw1 in int8 + dequantise + b1 + GELU, whole [P][4C] rows in fp32
  const int cq = c / 4;
  const int* yw = reinterpret_cast<const int*>(yq);
  for (int item = tid; item < groups * c4; item += THREADS) {
    const int g = item / c4;
    const int j = item - g * c4;
    int a[PT8];
#pragma unroll
    for (int i = 0; i < PT8; ++i) a[i] = 0;
    for (int q = 0; q < cq; ++q) {
      const int wv = w1p[(long long)q * c4 + j];
#pragma unroll
      for (int i = 0; i < PT8; ++i) a[i] = __dp4a(yw[(g * PT8 + i) * cq + q], wv, a[i]);
    }
    const float bj = to_f<T>(b1[j]);
    const float wsj = ws1[j];
#pragma unroll
    for (int i = 0; i < PT8; ++i) {
      const int p = g * PT8 + i;
      const float v = (float)a[i] * (s1[p] * wsj) + bj;
      hid[p * c4 + j] = gelu(v, gelu_tanh);
    }
  }
  __syncthreads();

  // (d) per-pixel int8 quantisation of pw2's input
  for (int p = warp; p < p_tile; p += THREADS / 32) {
    const float scale = warp_quantize_row(hid + p * c4, hq + p * c4, c4);
    if (lane == 0) s2[p] = scale;
  }
  __syncthreads();

  // (e) pw2 in int8 + dequantise + b2, layer scale, residual, one store in T
  const int* hw4 = reinterpret_cast<const int*>(hq);
  for (int item = tid; item < groups * c; item += THREADS) {
    const int g = item / c;
    const int ch = item - g * c;
    int a[PT8];
#pragma unroll
    for (int i = 0; i < PT8; ++i) a[i] = 0;
    for (int q = 0; q < c; ++q) {
      const int wv = w2p[(long long)q * c + ch];
#pragma unroll
      for (int i = 0; i < PT8; ++i) a[i] = __dp4a(hw4[(g * PT8 + i) * c + q], wv, a[i]);
    }
    const float bc = to_f<T>(b2[ch]);
    const float wsc = ws2[ch];
    const float gc = to_f<T>(gamma[ch]);
#pragma unroll
    for (int i = 0; i < PT8; ++i) {
      const int p = g * PT8 + i;
      const long long pix = pix0 + p;
      if (pix < total) {
        const long long at = pix * c + ch;
        const float o = ((float)a[i] * (s2[p] * wsc) + bc) * gc;
        out[at] = from_f<T>(to_f<T>(x[at]) + o);
      }
    }
  }
}

template <typename T>
cudaError_t launch_int8(const void* x, const void* dwk, const void* dwb, const float* ns,
                        const float* nb, const int* w1p, const float* ws1, const void* b1,
                        const int* w2p, const float* ws2, const void* b2, const void* gamma,
                        void* out, int n, int h, int w, int c, float eps, int gelu_tanh,
                        cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int candidates[4] = {64, 32, 16, 8};
  const int p = pick_tile(candidates, 4, total, [&](int q) { return smem_bytes_int8(q, c); });
  if (p < 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_int8(p, c);
  cudaError_t err = cudaFuncSetAttribute(fused_block_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((total + p - 1) / p);
  fused_block_int8_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dwk), static_cast<const T*>(dwb), ns, nb,
      w1p, ws1, static_cast<const T*>(b1), w2p, ws2, static_cast<const T*>(b2),
      static_cast<const T*>(gamma), static_cast<T*>(out), n, h, w, c, p, eps, gelu_tanh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The fp / bf16 block: the depthwise halo tile into ``ws`` (fp32 [n*H*W, C],
// the caller's workspace), then ln_mlp, both on ``stream``.  dtype: 0 =
// float32, 1 = bfloat16.  C % 4 == 0 and C <= 1536.  Returns a cudaError_t
// (0 = success).
int mmg_fused_block(int dtype, const void* x, const void* dwk, const void* dwb,
                    const float* ns, const float* nb, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* gamma, void* out, float* ws,
                    int n, int h, int w, int c, float eps, int gelu_tanh, void* stream) {
  if (!block_args_ok(n, h, w, c) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * h * w;
  if (dtype == 0) {
    const cudaError_t err = dwtile::launch<float, float>(x, dwk, dwb, ws, n, h, w, c, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_ln_mlp<float>(ws, x, ns, nb, w1, b1, w2, b2, gamma, out, total, c, eps,
                                     gelu_tanh, s);
  }
  const cudaError_t err = dwtile::launch<__nv_bfloat16, float>(x, dwk, dwb, ws, n, h, w, c, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ln_mlp<__nv_bfloat16>(ws, x, ns, nb, w1, b1, w2, b2, gamma, out, total, c,
                                           eps, gelu_tanh, s);
}

// The block's two halves alone, for timing each: the depthwise front half
// into ``ws``, and ln_mlp from ``ws``.  Same arguments as mmg_fused_block.
int mmg_fused_block_depthwise(int dtype, const void* x, const void* dwk, const void* dwb,
                              float* ws, int n, int h, int w, int c, void* stream) {
  if (!block_args_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dwtile::launch<float, float>(x, dwk, dwb, ws, n, h, w, c, s);
  if (dtype == 1) return (int)dwtile::launch<__nv_bfloat16, float>(x, dwk, dwb, ws, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

int mmg_fused_block_ln_mlp(int dtype, const float* ws, const void* x, const float* ns,
                           const float* nb, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* gamma, void* out, int n, int h, int w,
                           int c, float eps, int gelu_tanh, void* stream) {
  if (!block_args_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * h * w;
  if (dtype == 0)
    return (int)launch_ln_mlp<float>(ws, x, ns, nb, w1, b1, w2, b2, gamma, out, total, c, eps,
                                     gelu_tanh, s);
  if (dtype == 1)
    return (int)launch_ln_mlp<__nv_bfloat16>(ws, x, ns, nb, w1, b1, w2, b2, gamma, out, total, c,
                                             eps, gelu_tanh, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 block.  dtype: 0 = float32, 1 = bfloat16 (x, dwk, dwb, b1, b2,
// gamma, out); w1p / w2p packed int8 weights and ws1 / ws2 their fp32 scales
// (see above).  Returns a cudaError_t (0 = success).
int mmg_fused_block_int8(int dtype, const void* x, const void* dwk, const void* dwb,
                         const float* ns, const float* nb, const int* w1p, const float* ws1,
                         const void* b1, const int* w2p, const float* ws2, const void* b2,
                         const void* gamma, void* out, int n, int h, int w, int c, float eps,
                         int gelu_tanh, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_int8<float>(x, dwk, dwb, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma, out,
                                   n, h, w, c, eps, gelu_tanh, s);
  if (dtype == 1)
    return (int)launch_int8<__nv_bfloat16>(x, dwk, dwb, ns, nb, w1p, ws1, b1, w2p, ws2, b2,
                                           gamma, out, n, h, w, c, eps, gelu_tanh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
