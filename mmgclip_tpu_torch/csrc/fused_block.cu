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
//
// The int8 block (mmg_fused_block_int8) is the same two launches with
// ln_mlp_int8 as the back half: the pointwise products on the int8 tensor
// cores (see its notes below).

#include "common.cuh"
#include "depthwise_tile.cuh"

#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

namespace {

using namespace mmg;

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

// int8 of v at scale s, the plain version's formula: clip(rint(v / s), +-127)
__device__ __forceinline__ int quant8(float v, float s) {
  return (int)fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}
__device__ __forceinline__ unsigned short pack_s8(int lo, int hi) {
  return (unsigned short)((lo & 0xff) | ((hi & 0xff) << 8));
}

// LN of ROWS rows of y at once (rows r, r + step, ...), a lane holding the
// channel pairs 2 lane + 64 i, i < PAIRS, of each (C <= 64 * PAIRS): one
// round trip to device memory for all of them, 8-byte loads, and the LN
// affine read once.  Rows past bm are skipped, rows past n*H*W are zeros.
// With T = int8_t (the int8 block) each row is quantised with one scale,
// max(amax over C, 1e-8) * float(1/127), stored in ``scales[row]``.
template <typename T, int ROWS, int PAIRS>
__device__ __forceinline__ void ln_rows(T* As, int a_stride, int cp, int r, int step, int bm,
                                        long long pix0, long long total, const float* __restrict__ y,
                                        const float* __restrict__ ns, const float* __restrict__ nb,
                                        int c, float eps, float* scales = nullptr) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
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
    auto norm = [&](int i) {  // the LN output of pair i (the same bits every time)
      return live && 2 * lane + 64 * i < c
                 ? make_float2((v[q][i].x - mean) * rstd * scale[i].x + shift[i].x,
                               (v[q][i].y - mean) * rstd * scale[i].y + shift[i].y)
                 : make_float2(0.0f, 0.0f);
    };
    float s = 1.0f;
    if constexpr (INT8) {
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const float2 o = norm(i);
        amax = fmaxf(amax, fmaxf(fabsf(o.x), fabsf(o.y)));
      }
      s = fmaxf(warp_max(amax), 1e-8f) * (1.0f / 127.0f);
      if (lane == 0) scales[rr] = s;
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int ch = 2 * lane + 64 * i;
      if (ch < cp) {
        const float2 o = norm(i);
        if constexpr (INT8) {
          *reinterpret_cast<unsigned short*>(arow + ch) = pack_s8(quant8(o.x, s), quant8(o.y, s));
        } else if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<unsigned*>(arow + ch) = pack_bf16(o.x, o.y);
        } else {
          *reinterpret_cast<float2*>(arow + ch) = o;
        }
      }
    }
    for (int ch = 2 * lane + 64 * PAIRS; ch < cp; ch += 64) {
      if constexpr (INT8) {
        *reinterpret_cast<unsigned short*>(arow + ch) = 0;
      } else {
        arow[ch] = from_f<T>(0.0f);
        arow[ch + 1] = from_f<T>(0.0f);
      }
    }
  }
}

// (iii) the epilogue: each warp writes its O fragments (A: fp32, or int32
// for the int8 block) into the O tile [bm, C] (rows padded by 4) in shared
// memory at ``tile``, over the spent weight stages, A and H tiles; then the
// CTA reads the tile back by 4-vectors and hands each to ``finish(pix, row,
// col, o)``, which stores output row ``pix``'s columns col..col + 3
// (coalesced).  In a split row tile, each CTA of the cluster holds its
// partial O, and CTA `rank` sums every CTA's partial for its share of the
// groups through distributed shared memory, in the fixed order 0, 1, ...,
// parts - 1 (the same bits on every launch; int32 sums are exact in any
// order).
template <typename A, typename Finish>
__device__ __forceinline__ void store_tile(unsigned char* tile, const A (&acc)[OUT_BLOCKS][4], int bm,
                                           int r0, int ocol0, int oblocks, int rank, int parts,
                                           long long pix0, long long total, int c, Finish finish) {
  namespace cg = cooperative_groups;
  using V = typename std::conditional<std::is_same<A, float>::value, float4, int4>::type;
  using V2 = typename std::conditional<std::is_same<A, float>::value, float2, int2>::type;
  A* part = reinterpret_cast<A*>(tile);  // [bm][C + 4]: the fragment rows 4 banks apart
  const int ostride = c + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp is done with the stages, the A and the H tile
#pragma unroll
  for (int blk = 0; blk < OUT_BLOCKS; ++blk) {
    const int n = ocol0 + blk * 8 + 2 * t;
    if (blk < oblocks && n < c) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<V2*>(part + (size_t)(r0 + g + 8 * half) * ostride + n) =
            V2{acc[blk][2 * half], acc[blk][2 * half + 1]};
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
    V o;
    if (parts == 1) {
      o = *reinterpret_cast<const V*>(part + at_tile);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      o = *reinterpret_cast<const V*>(cluster.map_shared_rank(part, 0) + at_tile);
      for (int q = 1; q < parts; ++q) {
        const V v = *reinterpret_cast<const V*>(cluster.map_shared_rank(part, q) + at_tile);
        o.x += v.x; o.y += v.y; o.z += v.z; o.w += v.w;
      }
    }
    finish(pix, row, col, o);
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
  store_tile(smem_raw, acc, bm, r0, ocol0, oblocks, rank, p.split, pix0, total, c,
             [&](long long pix, int, int col, float4 o) {
               const long long at = pix * c + col;
               const float4 xv = load4(x + at), bv = load4(b2 + col), gv = load4(gamma + col);
               store4(out + at, make_float4(xv.x + (o.x + bv.x) * gv.x, xv.y + (o.y + bv.y) * gv.y,
                                            xv.z + (o.z + bv.z) * gv.z, xv.w + (o.w + bv.w) * gv.w));
             });
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

// The grid of a plan over ``total`` rows: the row tiles times the CTAs that
// share each (pick_split), which it sets in the plan.
inline cudaError_t plan_grid(MlpPlan& p, long long total, long long* blocks) {
  const long long bm = 16LL * p.wm;
  const long long row_tiles = (total + bm - 1) / bm;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  p.split = pick_split(row_tiles, p.chunks, sms);
  *blocks = row_tiles * p.split;
  return *blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

// Launch a plan's kernel on ``blocks`` CTAs in clusters of p.split.
template <typename... Params, typename... Args>
cudaError_t launch_plan(void (*kernel)(Params...), const MlpPlan& p, long long blocks,
                        cudaStream_t stream, Args... args) {
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
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t launch_ln_mlp(const float* y, const void* x, const float* ns, const float* nb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* gamma, void* out, long long total, int c, float eps,
                          int gelu_tanh, cudaStream_t stream) {
  auto kernel = ln_mlp_kernel<T>;
  int max_smem = 0;
  cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  MlpPlan p = plan_mlp<T>(c, max_smem);
  if (p.wm == 0) return cudaErrorInvalidValue;
  long long blocks = 0;
  err = plan_grid(p, total, &blocks);
  if (err != cudaSuccess) return err;
  const bool vec1 = reinterpret_cast<uintptr_t>(w1) % 16 == 0;  // rows of 4C elements: 16-byte multiples
  const bool vec2 = reinterpret_cast<uintptr_t>(w2) % 16 == 0 && (c * sizeof(T)) % 16 == 0;
  return launch_plan(kernel, p, blocks, stream, y, static_cast<const T*>(x), ns, nb,
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
// ln_mlp_int8: the back half of the int8 block (replaces `_fused_call_int8`
// of mmgclip_tpu/ops/fused_block.py and the `quant=True` route of
// `_fused_call_banded`) on the int8 tensor cores, mma.sync m16n8k32 s8 with
// exact int32 sums.
//
// What it computes (plain_convnext_block_int8 in ops/fused_block.py):
//   * weights quantised by the wrapper per output channel (scale
//     max(amax, 1e-8) / 127, round half to even, clip to +-127) and packed
//     four K rows to an int32 word: w1p [C/4][4C], w2p [C][C] (word (q, j)
//     holds rows 4q..4q+3 of column j, the lowest byte first), which is the
//     mma's B fragment: b0 = word (k0/4 + t, n0 + g), b1 four words further;
//   * ONE ACTIVATION SCALE PER PIXEL: the LN output over its C channels
//     before pw1, the GELU output over its 4C hidden units before pw2;
//     scale = max(amax, 1e-8) * float(1/127), q = clip(rint(v / scale),
//     +-127).  The partition depends on the tensor's shape alone, never on
//     the launch, so masked (bucketed) encodes equal exact-shape ones (pad
//     pixels never share a scale with real ones).  (The JAX kernel's scale
//     is per row chunk, which follows its VMEM tiling.)
//   * fp32 for the depthwise, LN, GELU and the dequantised sums, which
//     follow the plain version's roundings ((float)acc * (s * ws) + b, then
//     the layer scale and the residual); nothing is rounded to T inside.
//
// Design: ln_mlp's tile plan with int8 tiles.  A CTA owns BM rows and all C
// channels, WM x WN warps; the LN prologue quantises each row into the int8
// A tile [BM, Cp] (Cp = C rounded up to 32, the mma's K, zero-filled) and
// keeps its scale s1.  pw2's scale needs the whole 4C GELU row before any
// pw2 product, and the row does not fit on chip at C = 768, so the hidden
// chunks are walked twice:
//   pass 1: pw1, dequantise, b1, GELU, and only a running max |GELU| per
//           row; reduced over the warps (atomicMax on the float bits: exact
//           in any order) and over the CTAs of a cluster (distributed shared
//           memory) into s2;
//   pass 2: the same pw1 and GELU (the same code, so the same bits),
//           quantised with the row's s2 into the int8 H tile [BM, HN], then
//           pw2 into int32 O fragments.  s2 is constant along the row, so
//           the chunks' int32 partial sums (|sum| <= 4C * 127^2 < 2^31) add
//           exactly, also across a cluster; the epilogue dequantises once.
// The weight tiles (W1 [KS1 / 4 word rows, HN], W2 [KS2 / 4, Cp], words)
// stream through shared memory by 16-byte cp.async in stages, one barrier a
// tile: pass 1's W1 tiles, then each chunk's W1 and W2 tiles.  Fragments:
// ldmatrix for A and H (16-byte rows are 8 x 8 b16 matrices), 32-bit loads
// of the packed words for B, rows padded against bank conflicts.  The
// recompute costs one more pw1 and GELU a pixel: 1.5x the function's
// products at twice the bf16 rate.  What bounds it: 16*C^2 int8 operations
// per pixel against 2*C*sizeof(T) bytes, so operations at every stage.

constexpr int MAX_C_INT8 = 768;        // the LN prologue holds a row in registers
constexpr int I8_HIDDEN = 64;          // hidden units of a chunk a warp computes (8 blocks)
constexpr int I8_STAGE_WORDS = 16384;  // a weight stage holds at most 64 KB

// The int8 plan: a_stride and h_stride in bytes; w1_stride, w2_stride and
// stage_elems in 32-bit words; ks1 and ks2 in K rows (multiples of 32).
// Shared memory: s1, s2 and the row maxima [BM] each, then the stages, the
// A and the H tile; the int32 O tile [BM, C] of the epilogue reuses all but
// the scales.
__host__ __device__ inline size_t int8_head_bytes(int bm) { return (size_t)(3 * bm * 4 + 15) / 16 * 16; }

MlpPlan plan_mlp_int8(int c, int max_smem) {
  MlpPlan p{};
  p.split = 1;
  p.cp = (c + 31) / 32 * 32;
  p.wn = (p.cp + 95) / 96;
  p.nw = ((p.cp + p.wn - 1) / p.wn + 7) / 8 * 8;
  p.hw = I8_HIDDEN;
  p.hn = p.hw * p.wn;
  p.a_stride = p.cp + 16;  // 16-byte rows an odd count apart: ldmatrix free of conflicts
  p.h_stride = p.hn + 16;
  p.w1_stride = p.hn + 8;  // = 8 mod 32 words: lanes (g, t) read 32 banks
  p.w2_stride = p.cp + 8;
  p.ks1 = std::min(p.cp, std::max(1, I8_STAGE_WORDS / p.w1_stride / 8) * 32);
  p.ks2 = std::min(p.hn, std::max(1, I8_STAGE_WORDS / p.w2_stride / 8) * 32);
  p.stage_elems = std::max(p.ks1 / 4 * p.w1_stride, p.ks2 / 4 * p.w2_stride);
  p.n1 = (p.cp + p.ks1 - 1) / p.ks1;
  p.n2 = (p.hn + p.ks2 - 1) / p.ks2;
  p.chunks = (4 * c + p.hn - 1) / p.hn;
  const int max_warps = MLP_THREADS / 32;
  if (p.wn > max_warps) return p;
  for (int wm = max_warps / p.wn; wm >= 1; wm /= 2) {
    const int bm = 16 * wm;
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      const size_t bytes = int8_head_bytes(bm) +
                           std::max((size_t)stages * p.stage_elems * 4 +
                                        (size_t)bm * (p.a_stride + p.h_stride),
                                    (size_t)bm * (c + 4) * 4);
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

// dequantise an int32 sum: (float)acc * (s * w) + b, rounded as the plain
// version rounds (no contraction into an FMA)
__device__ __forceinline__ float dequant(int acc, float s, float w, float b) {
  return __fadd_rn(__fmul_rn((float)acc, __fmul_rn(s, w)), b);
}

template <typename T>
__global__ void __launch_bounds__(MLP_THREADS, 1)
ln_mlp_int8_kernel(const float* __restrict__ y, const T* __restrict__ x,
                   const float* __restrict__ ns, const float* __restrict__ nb,
                   const int* __restrict__ w1p, const float* __restrict__ ws1,
                   const T* __restrict__ b1, const int* __restrict__ w2p,
                   const float* __restrict__ ws2, const T* __restrict__ b2,
                   const T* __restrict__ gamma, T* __restrict__ out, long long total, int c,
                   float eps, int gelu_tanh, MlpPlan p) {
  namespace cg = cooperative_groups;
  constexpr int HB = I8_HIDDEN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bm = 16 * p.wm;
  float* s1 = reinterpret_cast<float*>(smem_raw);            // [bm] pw1's input scale a row
  float* s2 = s1 + bm;                                       // [bm] pw2's
  unsigned* rowmax = reinterpret_cast<unsigned*>(s2 + bm);   // [bm] max |GELU| (float bits)
  unsigned char* body = smem_raw + int8_head_bytes(bm);
  int* wbuf = reinterpret_cast<int*>(body);                  // [stages][stage_elems] words
  int8_t* As = reinterpret_cast<int8_t*>(wbuf + (size_t)p.stages * p.stage_elems);  // [bm][a_stride]
  int8_t* Hs = As + (size_t)bm * p.a_stride;                 // [bm][h_stride]

  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / p.wn, wn = warp - wm * p.wn;
  const int r0 = 16 * wm;
  const int rank = p.split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long pix0 = (long long)((blockIdx.x - rank) / p.split) * bm;
  const int chunk0 = rank * (p.chunks / p.split) + min(rank, p.chunks % p.split);
  const int my_chunks = p.chunks / p.split + (rank < p.chunks % p.split ? 1 : 0);
  const int c4 = 4 * c;
  // pass 1 is the first n1 * my_chunks tiles (W1 only), pass 2 the rest
  // (each chunk's n1 W1 tiles, then its n2 W2 tiles)
  const int pass1 = my_chunks * p.n1;
  const int count = pass1 + my_chunks * (p.n1 + p.n2);
  const int hcol0 = wn * p.hw;
  const int ocol0 = wn * p.nw, oblocks = max(0, min(p.nw, p.cp - ocol0)) / 8;
  const int arow = lane & 15, abyte = (lane >> 4) * 16;  // ldmatrix rows and their 16-byte halves

  // tile -> (chunk of this CTA, step within the chunk: W1 tiles < n1 <= W2 tiles)
  auto step_of = [&](int i) {
    if (i < pass1) return make_int2(i / p.n1, i % p.n1);
    const int u = i - pass1, per = p.n1 + p.n2;
    return make_int2(u / per, u % per);
  };
  auto stage_of = [&](int i) { return wbuf + (size_t)(i % p.stages) * p.stage_elems; };

  auto fetch = [&](int i) {
    int* buf = stage_of(i);
    const int2 st = step_of(i);
    const int j0 = (chunk0 + st.x) * p.hn;
    if (st.y < p.n1) {  // word rows q of W1 (K rows 4q..4q+3), the chunk's HN columns
      const int q0 = st.y * p.ks1 / 4, rows = min(p.ks1, p.cp - st.y * p.ks1) / 4;
      const int per_row = p.hn / 4;
      for (int e = threadIdx.x; e < rows * per_row; e += nthreads) {
        const int r = e / per_row, col = (e - r * per_row) * 4;
        const int q = q0 + r, j = j0 + col;
        const bool ok = 4 * q < c && j < c4;  // 4C % 4 == 0: a copy lies wholly inside or past it
        cp_async16(buf + r * p.w1_stride + col, ok ? w1p + (long long)q * c4 + j : w1p, ok ? 16 : 0);
      }
    } else {  // word rows of W2 (hidden units j..j+3 of the chunk), Cp columns
      const int q0 = (st.y - p.n1) * p.ks2 / 4;
      const int rows = min(p.ks2, p.hn - (st.y - p.n1) * p.ks2) / 4, per_row = p.cp / 4;
      for (int e = threadIdx.x; e < rows * per_row; e += nthreads) {
        const int r = e / per_row, col = (e - r * per_row) * 4;
        const int j = j0 + 4 * (q0 + r);
        const bool ok = j < c4 && col < c;  // C % 4 == 0
        cp_async16(buf + r * p.w2_stride + col, ok ? w2p + (long long)(j / 4) * c + col : w2p,
                   ok ? 16 : 0);
      }
    }
  };

  for (int r = threadIdx.x; r < bm; r += nthreads) rowmax[r] = 0u;
  for (int i = 0; i < p.stages - 1; ++i) {  // the first tiles' copies run under the LN
    if (i < count) fetch(i);
    cp_async_commit();
  }

  // (i) LN over C in fp32, one warp per row, quantised into the A tile with
  // the row's scale s1
  if (c <= 192) {
    for (int r = warp; r < bm; r += 8 * nwarps)
      ln_rows<int8_t, 8, 3>(As, p.a_stride, p.cp, r, nwarps, bm, pix0, total, y, ns, nb, c, eps, s1);
  } else {  // C <= MAX_C_INT8
    for (int r = warp; r < bm; r += 2 * nwarps)
      ln_rows<int8_t, 2, 12>(As, p.a_stride, p.cp, r, nwarps, bm, pix0, total, y, ns, nb, c, eps, s1);
  }

  int acc1[HB][4], acc[OUT_BLOCKS][4];
#pragma unroll
  for (int i = 0; i < HB; ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0;
#pragma unroll
  for (int i = 0; i < OUT_BLOCKS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  float mlo = 0.0f, mhi = 0.0f;  // pass 1: max |GELU| of rows r0 + g, r0 + g + 8 over my columns

  for (int i = 0; i < count; ++i) {
    if (i == pass1) {
      // pass 1 is done: the row maxima over the quad, the warps and the
      // cluster -> s2 (visible to all after the barrier below)
      mlo = fmaxf(mlo, __shfl_xor_sync(0xffffffffu, mlo, 1));
      mlo = fmaxf(mlo, __shfl_xor_sync(0xffffffffu, mlo, 2));
      mhi = fmaxf(mhi, __shfl_xor_sync(0xffffffffu, mhi, 1));
      mhi = fmaxf(mhi, __shfl_xor_sync(0xffffffffu, mhi, 2));
      if (t == 0) {
        atomicMax(rowmax + r0 + g, __float_as_uint(mlo));
        atomicMax(rowmax + r0 + g + 8, __float_as_uint(mhi));
      }
      if (p.split > 1) {
        cg::this_cluster().sync();
      } else {
        __syncthreads();
      }
      for (int r = threadIdx.x; r < bm; r += nthreads) {
        unsigned m = rowmax[r];
        for (int q = 0; q < p.split && p.split > 1; ++q)
          m = max(m, cg::this_cluster().map_shared_rank(rowmax, q)[r]);
        s2[r] = fmaxf(__uint_as_float(m), 1e-8f) * (1.0f / 127.0f);
      }
    }
    switch (p.stages) {  // this thread's copies of the tile have landed
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      case 4: cp_async_wait<2>(); break;
      case 5: cp_async_wait<3>(); break;
      case 6: cp_async_wait<4>(); break;
      case 7: cp_async_wait<5>(); break;
      default: cp_async_wait<6>(); break;
    }
    __syncthreads();  // tile landed for all; A / H / s2 writes visible; the oldest stage is free
    const int ahead = i + p.stages - 1;
    if (ahead < count) fetch(ahead);
    cp_async_commit();
    const int* buf = stage_of(i);
    const int2 st = step_of(i);
    if (st.y < p.n1) {
      // pw1: acc1 += A[rows, k0 : k0 + krows] . W1 tile
      const int k0 = st.y * p.ks1, krows = min(p.ks1, p.cp - k0);
      for (int kk = 0; kk < krows; kk += 32) {
        unsigned a[4];
        ldmatrix_x4(a, As + (size_t)(r0 + arow) * p.a_stride + k0 + kk + abyte);
        const int* br = buf + (kk / 4 + t) * p.w1_stride + hcol0 + g;
#pragma unroll
        for (int blk = 0; blk < HB; ++blk)
          mma_s8(acc1[blk], a, br[blk * 8], br[blk * 8 + 4 * p.w1_stride]);
      }
      if (st.y == p.n1 - 1) {
        // dequantise, + b1, GELU (hidden units past 4C are 0); pass 1 keeps
        // the row maxima, pass 2 quantises with s2 into the H tile
        const bool second = i >= pass1;
        const int j0 = (chunk0 + st.x) * p.hn;
        const float sa = s1[r0 + g], sb = s1[r0 + g + 8];
        const float qa = second ? s2[r0 + g] : 1.0f, qb = second ? s2[r0 + g + 8] : 1.0f;
#pragma unroll
        for (int blk = 0; blk < HB; ++blk) {
          const int col = hcol0 + blk * 8 + 2 * t, j = j0 + col;
          const bool ok = j < c4;  // j even and 4C % 4 == 0: j + 1 < 4C too
          const float w0 = ok ? ws1[j] : 0.0f, w1 = ok ? ws1[j + 1] : 0.0f;
          const float bj0 = ok ? to_f<T>(b1[j]) : 0.0f, bj1 = ok ? to_f<T>(b1[j + 1]) : 0.0f;
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hv[e] = ok ? gelu(dequant(acc1[blk][e], e < 2 ? sa : sb, e & 1 ? w1 : w0,
                                      e & 1 ? bj1 : bj0),
                              gelu_tanh)
                       : 0.0f;
          if (!second) {
            mlo = fmaxf(mlo, fmaxf(fabsf(hv[0]), fabsf(hv[1])));
            mhi = fmaxf(mhi, fmaxf(fabsf(hv[2]), fabsf(hv[3])));
          } else {
            *reinterpret_cast<unsigned short*>(Hs + (size_t)(r0 + g) * p.h_stride + col) =
                pack_s8(quant8(hv[0], qa), quant8(hv[1], qa));
            *reinterpret_cast<unsigned short*>(Hs + (size_t)(r0 + g + 8) * p.h_stride + col) =
                pack_s8(quant8(hv[2], qb), quant8(hv[3], qb));
          }
          acc1[blk][0] = acc1[blk][1] = acc1[blk][2] = acc1[blk][3] = 0;
        }
      }
    } else {
      // pw2: acc += H[rows, k0 : k0 + krows] . W2 tile
      const int k0 = (st.y - p.n1) * p.ks2, krows = min(p.ks2, p.hn - k0);
      for (int kk = 0; kk < krows; kk += 32) {
        unsigned a[4];
        ldmatrix_x4(a, Hs + (size_t)(r0 + arow) * p.h_stride + k0 + kk + abyte);
        const int* br = buf + (kk / 4 + t) * p.w2_stride + ocol0 + g;
#pragma unroll
        for (int blk = 0; blk < OUT_BLOCKS; ++blk)
          if (blk < oblocks) mma_s8(acc[blk], a, br[blk * 8], br[blk * 8 + 4 * p.w2_stride]);
      }
    }
  }
  cp_async_wait<0>();
  // (iii) out = x + gamma * ((float)O * (s2 * ws2) + b2), as the plain version rounds
  store_tile(body, acc, bm, r0, ocol0, oblocks, rank, p.split, pix0, total, c,
             [&](long long pix, int row, int col, int4 o) {
               const long long at = pix * c + col;
               const float s = s2[row];
               const float4 xv = load4(x + at), bv = load4(b2 + col), gv = load4(gamma + col);
               const float4 wv = *reinterpret_cast<const float4*>(ws2 + col);
               store4(out + at,
                      make_float4(__fadd_rn(xv.x, __fmul_rn(dequant(o.x, s, wv.x, bv.x), gv.x)),
                                  __fadd_rn(xv.y, __fmul_rn(dequant(o.y, s, wv.y, bv.y), gv.y)),
                                  __fadd_rn(xv.z, __fmul_rn(dequant(o.z, s, wv.z, bv.z), gv.z)),
                                  __fadd_rn(xv.w, __fmul_rn(dequant(o.w, s, wv.w, bv.w), gv.w))));
             });
}

template <typename T>
cudaError_t launch_ln_mlp_int8(const float* y, const void* x, const float* ns, const float* nb,
                               const int* w1p, const float* ws1, const void* b1, const int* w2p,
                               const float* ws2, const void* b2, const void* gamma, void* out,
                               long long total, int c, float eps, int gelu_tanh,
                               cudaStream_t stream) {
  // 16-byte copies of the packed weights, 4-vectors of ws2 (the wrapper's
  // fresh allocations are aligned)
  if (reinterpret_cast<uintptr_t>(w1p) % 16 || reinterpret_cast<uintptr_t>(w2p) % 16 ||
      reinterpret_cast<uintptr_t>(ws2) % 16)
    return cudaErrorMisalignedAddress;
  auto kernel = ln_mlp_int8_kernel<T>;
  int max_smem = 0;
  cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  MlpPlan p = plan_mlp_int8(c, max_smem);
  if (p.wm == 0) return cudaErrorInvalidValue;
  long long blocks = 0;
  err = plan_grid(p, total, &blocks);
  if (err != cudaSuccess) return err;
  return launch_plan(kernel, p, blocks, stream, y, static_cast<const T*>(x), ns, nb, w1p, ws1,
                     static_cast<const T*>(b1), w2p, ws2, static_cast<const T*>(b2),
                     static_cast<const T*>(gamma), static_cast<T*>(out), total, c, eps, gelu_tanh,
                     p);
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
// into ``ws`` (the fp and the int8 block's), and ln_mlp from ``ws``.  Same
// arguments as mmg_fused_block.
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

// The int8 block: the depthwise halo tile into ``ws``, then ln_mlp_int8.
// dtype: 0 = float32, 1 = bfloat16 (x, dwk, dwb, b1, b2, gamma, out); w1p /
// w2p the packed int8 weights (16-byte aligned) and ws1 / ws2 their fp32
// scales (see ln_mlp_int8).  C % 4 == 0 and C <= 768.  Returns a
// cudaError_t (0 = success).
int mmg_fused_block_int8(int dtype, const void* x, const void* dwk, const void* dwb,
                         const float* ns, const float* nb, const int* w1p, const float* ws1,
                         const void* b1, const int* w2p, const float* ws2, const void* b2,
                         const void* gamma, void* out, float* ws, int n, int h, int w, int c,
                         float eps, int gelu_tanh, void* stream) {
  if (!block_args_ok(n, h, w, c) || c > MAX_C_INT8 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * h * w;
  if (dtype == 0) {
    const cudaError_t err = dwtile::launch<float, float>(x, dwk, dwb, ws, n, h, w, c, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_ln_mlp_int8<float>(ws, x, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma, out,
                                          total, c, eps, gelu_tanh, s);
  }
  const cudaError_t err = dwtile::launch<__nv_bfloat16, float>(x, dwk, dwb, ws, n, h, w, c, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ln_mlp_int8<__nv_bfloat16>(ws, x, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma,
                                                out, total, c, eps, gelu_tanh, s);
}

// The int8 block's back half alone (ln_mlp_int8 from ``ws``), for timing.
int mmg_fused_block_ln_mlp_int8(int dtype, const float* ws, const void* x, const float* ns,
                                const float* nb, const int* w1p, const float* ws1, const void* b1,
                                const int* w2p, const float* ws2, const void* b2,
                                const void* gamma, void* out, int n, int h, int w, int c,
                                float eps, int gelu_tanh, void* stream) {
  if (!block_args_ok(n, h, w, c) || c > MAX_C_INT8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * h * w;
  if (dtype == 0)
    return (int)launch_ln_mlp_int8<float>(ws, x, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma, out,
                                          total, c, eps, gelu_tanh, s);
  if (dtype == 1)
    return (int)launch_ln_mlp_int8<__nv_bfloat16>(ws, x, ns, nb, w1p, ws1, b1, w2p, ws2, b2,
                                                  gamma, out, total, c, eps, gelu_tanh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
