// Causal latent attention of the DeepSeek-V3 text tower (MLA without query
// compression) over a padded bank chunk, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek-V3 tower.  It takes
// the place of the plain path (ops/mla_attention.py::plain_mla_attention),
// which widened q and k to float32 copies, ran Q K^T as an FFMA sgemm into a
// float32 [b, H, s, s] score tensor, scaled, masked and softmaxed it in three
// more passes and cast it to bf16: ~40 GB of device memory traffic a layer of
// a 256 x 512 chunk.  Here scores, mask, softmax and P V stay on chip.
//
// Contract (ops/mla_attention.py, "launch_mla_attention"):
//   * q [b, s, H * (NOPE + ROPE)] bf16: per head q_nope, then q_pe not yet
//     rotated; k_pe [b, s, ROPE] bf16, the one rope key every head shares, read
//     in place at its row stride (the kv_a projection's last columns); kv
//     [b, s, H * (NOPE + VD)] bf16: per head k_nope, then v.  The last
//     dimension of each is contiguous; the batch and position strides are any
//     multiple of 8 elements.
//   * cos, sin [s, ROPE / 2] float32 (models/deepseek_v3.py::rope_tables);
//     pair i of a q_pe or k_pe row at position p turns by their row p, in
//     float32 with products and sums rounded one by one (__fmul_rn /
//     __fadd_rn / __fsub_rn: no FMA contraction), then rounds to bf16: the
//     operands are bit-equal to rope_pairs' output.  Both null: no rotation
//     (NoPE, Kimi-Linear's latent attention), q_pe and k_pe used as given.
//   * mask [b, s] bytes (batch stride any, position stride 1): key j may be
//     attended by query i iff j <= i and mask[j] != 0 (attention_masks).
//     Masked keys score NEG_INF = -1e30 before the max, as the plain path's
//     masked_fill does; pad query positions attend to their row's valid keys
//     as the plain path computes them; a query with no allowed key (before
//     the row's first valid key, or a row without one) gets the plain path's
//     uniform softmax over all s keys: bf16(1 / s) times the sum of v.
//   * out [b, s, H * VD] bf16, contiguous: the context as o_proj reads it.
//   * q_rot [b, s, H, ROPE] and k_rot [b, s, ROPE] (bf16, may be null): the
//     rotated operands, written for the tests; k_rot only for the keys a CTA
//     of head 0 loaded.
//
// What bounds it on an H100: per (row, head) of L valid tokens in a chunk of
// width s, about 2 (NOPE + ROPE + VD) (L^2 / 2 + (s - L) L) operations against
// (NOPE + ROPE + NOPE + VD) * 2 bytes a key and (NOPE + ROPE + VD) * 2 a query
// moved: at a bank chunk's widths (256 rows of s = 512, L ~180) ~0.23 TFLOP
// computed, pad queries included (0.23 ms at the bf16 peak), against ~1.8 GB
// (0.55 ms at HBM's), so the products run on the tensor cores and every byte
// is moved once.
//
// Design (FlashAttention-2 shape, mma.sync):
//   * One CTA of 4 warps takes one (row, head, 64-query tile); each warp owns
//     16 query rows.  The tiles of one (row, head) are neighbours in the grid,
//     so their K / V reads hit L2; the heaviest (last) query tiles start first.
//   * The row's mask goes to shared memory once, with its first and last valid
//     key and each key tile's count of valid keys.  Key tiles of 64 are visited
//     up to min(the tile's last query, the row's last valid key): tiles wholly
//     past the diagonal or past the valid keys are neither loaded nor computed;
//     keys past that end are zero-filled, never read.  A tile holding a query
//     with no allowed key visits all s.  A warp applies the masks only to a key
//     tile that meets its diagonal, holds an invalid key or serves such a query.
//   * Q (64 x (NOPE + ROPE)) and each K tile (k_nope | k_pe) and V tile arrive by
//     16-byte cp.async into a two-stage ring, the next tile's copy in flight
//     under the current tile's products; q_pe and k_pe are rotated in shared
//     memory once landed.  Q fragments then stay in registers (ldmatrix).  The
//     copies are unrolled loops of fixed trip count with no branch: a loop with
//     a division and divergent branches a 16-byte chunk costs ~2,000
//     instructions a thread and tile, more than the products.
//   * S = Q K^T by mma.m16n8k16 (bf16 in, float32 sums; the products of bf16
//     operands are exact in float32, so only the order of summation differs
//     from the plain path's sgemm).  The online softmax runs on the S fragment
//     in float32 with the scale folded into exp2; P is rounded to bf16 in
//     registers (the plain path rounds its probabilities to bf16 too) and fed
//     straight to the P V mma as its A operand, V by ldmatrix.trans.
//   * No atomics on the output and a fixed order: a second launch is
//     bit-equal to the first.
//   Measured (chip_smoke.py phase 5e, PERF.md): 1.97 ms a layer of a 256 x 512
//   bank chunk against a 0.29 ms bound of its valid work; what is left is a
//   fixed cost a CTA (~3 us of SM time: the mask scan, Q's copy and rotation)
//   and the exposed latency of the RoPE tables' reads after each tile's barrier.

#include "common.cuh"

#include <math.h>

namespace {

using namespace mmg;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int WARPS = BQ / 16;   // each warp owns 16 query rows (the mma's M)
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ == BK, "the Q tile is staged in a K tile's buffer");
static_assert(THREADS == 2 * BK, "RoPE: two threads a row");

template <int NOPE, int ROPE, int VD>
struct Dims {
  static constexpr int QK = NOPE + ROPE;
  static constexpr int QKP = (QK + 31) / 32 * 32;  // S's depth, padded to two k-steps
  static constexpr int VDP = (VD + 15) / 16 * 16;  // P V's width, padded to two n-blocks
  static constexpr int KS = QKP + 8;               // shared row strides (elements):
  static constexpr int VS = VDP + 8;               // +16 bytes keeps ldmatrix conflict free
  static constexpr int K_ELEMS = BK * KS;
  static constexpr int STAGE = K_ELEMS + BK * VS;
  static constexpr size_t TILE_BYTES = 2 * STAGE * sizeof(bf16);
  static_assert(NOPE % 8 == 0 && ROPE % 8 == 0 && VD % 8 == 0, "16-byte copies");
};

// The shared memory past the K / V ring: the row's first and last valid key,
// the valid keys of each key tile, then the row's mask as bytes (zero past s,
// up to a whole key tile).
__host__ __device__ constexpr int key_tiles(int s) { return (s + BK - 1) / BK; }
__host__ __device__ constexpr int meta_bytes(int s) { return (2 + key_tiles(s) + 3) / 4 * 16; }
__host__ __device__ constexpr int tail_bytes(int s) { return meta_bytes(s) + key_tiles(s) * BK; }

// Rows [row0, row0 + BK) of a row-major source (row stride src_ss, columns
// [0, W)) into shared memory rows of stride DST_S: 16-byte cp.async, rows at
// or past `end` zero-filled.  A fixed trip count and no branch, so the copy
// costs a few instructions a chunk.
template <int W, int DST_S>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, long long src_ss,
                                          int row0, int end) {
  constexpr int CH = W / 8, TOTAL = BK * CH;
#pragma unroll
  for (int j = 0; j < (TOTAL + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (TOTAL % THREADS != 0 && i >= TOTAL) break;
    const int r = i / CH, c = i - r * CH;
    const bool ok = row0 + r < end;
    cp_async16(dst + r * DST_S + c * 8, ok ? src + (row0 + r) * src_ss + c * 8 : src, ok ? 16 : 0);
  }
}

// N consecutive floats (N a multiple of 2; 16-byte aligned when a multiple of 4)
template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* __restrict__ p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = a.x, v[4 * k + 1] = a.y, v[4 * k + 2] = a.z, v[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 a = reinterpret_cast<const float2*>(p)[k];
      v[2 * k] = a.x, v[2 * k + 1] = a.y;
    }
  }
}

// Rotate the rope columns [NOPE, NOPE + ROPE) of a tile's BK rows in shared
// memory: row r is position pos0 + r (rows at or past s are left as they are).
// Two threads a row, ROPE / 4 pairs each, the tables read as vectors.
// Optionally writes the rotated values to dst + position * dst_stride for the
// positions below `limit`.
template <int NOPE, int ROPE, int KS>
__device__ __forceinline__ void rotate(bf16* tile, int pos0, int s, const float* __restrict__ cos,
                                       const float* __restrict__ sin, bf16* dst,
                                       long long dst_stride, int limit) {
  constexpr int HALF = ROPE / 2, PER = ROPE / 4;
  const int r = threadIdx.x >> 1, p0 = (threadIdx.x & 1) * PER;
  const int pos = pos0 + r;
  if (pos >= s) return;
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(tile + r * KS + NOPE) + p0;
  if (cos != nullptr) {
    float c[PER], sn[PER];
    load_floats<PER>(c, cos + (long long)pos * HALF + p0);
    load_floats<PER>(sn, sin + (long long)pos * HALF + p0);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float2 ab = __bfloat1622float2(x[i]);
      x[i] = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(ab.x, c[i]), __fmul_rn(ab.y, sn[i])),
                                   __fadd_rn(__fmul_rn(ab.x, sn[i]), __fmul_rn(ab.y, c[i])));
    }
  }
  if (dst != nullptr && pos < limit) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + pos * dst_stride) + p0;
#pragma unroll
    for (int i = 0; i < PER; ++i) d[i] = x[i];
  }
}

template <int NOPE, int ROPE, int VD>
__global__ void __launch_bounds__(THREADS, 2)
mla_attention_kernel(const bf16* __restrict__ q, long long q_sb, long long q_ss,
                     const bf16* __restrict__ k_pe, long long kpe_sb, long long kpe_ss,
                     const bf16* __restrict__ kv, long long kv_sb, long long kv_ss,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     const unsigned char* __restrict__ mask, long long mask_sb,
                     bf16* __restrict__ out, bf16* __restrict__ q_rot, bf16* __restrict__ k_rot,
                     int heads, int s, float scale_log2) {
  using D = Dims<NOPE, ROPE, VD>;
  constexpr int KSTEPS = D::QKP / 16;  // k-steps of S = Q K^T
  constexpr int NT = D::VDP / 8;       // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  int* meta = reinterpret_cast<int*>(smem_raw + D::TILE_BYTES);  // first, last, per-tile counts
  int* tile_valid = meta + 2;
  unsigned char* keep = smem_raw + D::TILE_BYTES + meta_bytes(s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, row = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  auto kst = [&](int st) { return tiles + st * D::STAGE; };
  auto vst = [&](int st) { return tiles + st * D::STAGE + D::K_ELEMS; };

  // the row's mask, its first and last valid key and each key tile's count;
  // the padded columns of both stages zeroed once (the copies never touch them)
  for (int i = tid; i < 2 + key_tiles(s); i += THREADS) meta[i] = i == 0 ? s : (i == 1 ? -1 : 0);
  if constexpr (D::QKP > D::QK || D::VDP > VD) {
    for (int i = tid; i < 2 * BK; i += THREADS) {
      const int st = i / BK, r = i - st * BK;
      for (int c = D::QK; c < D::QKP; ++c) kst(st)[r * D::KS + c] = __float2bfloat16(0.0f);
      for (int c = VD; c < D::VDP; ++c) vst(st)[r * D::VS + c] = __float2bfloat16(0.0f);
    }
  }
  __syncthreads();
  {
    const unsigned char* m = mask + row * mask_sb;
    int lo = s, hi = -1;
    for (int j = tid; j < key_tiles(s) * BK; j += THREADS) {
      const unsigned char k = j < s && m[j] != 0;
      keep[j] = k;
      if (k) {
        lo = min(lo, j);
        hi = max(hi, j);
        atomicAdd(&tile_valid[j / BK], 1);
      }
    }
    if (hi >= 0) {
      atomicMin(&meta[0], lo);
      atomicMax(&meta[1], hi);
    }
  }
  __syncthreads();
  const int first = meta[0], last = meta[1];
  // a query before the first valid key has no allowed key: its tile visits all s
  const bool uniform = q0 < first;
  const int key_end = uniform ? s : min(min(q0 + BQ, s), last + 1);
  const int n_tiles = key_tiles(key_end);

  const bf16* kv_row = kv + row * kv_sb + (long long)h * (NOPE + VD);
  const bf16* kpe_row = k_pe + row * kpe_sb;
  auto load_kv = [&](int st, int key0) {
    copy_rows<NOPE, D::KS>(kst(st), kv_row, kv_ss, key0, key_end);
    copy_rows<ROPE, D::KS>(kst(st) + NOPE, kpe_row, kpe_ss, key0, key_end);
    copy_rows<VD, D::VS>(vst(st), kv_row + NOPE, kv_ss, key0, key_end);
  };
  bf16* k_rot_row = (k_rot == nullptr || h != 0) ? nullptr : k_rot + (long long)row * s * ROPE;

  // Q tile into stage 1's K buffer, the first K / V tile into stage 0
  copy_rows<D::QK, D::KS>(kst(1), q + row * q_sb + (long long)h * D::QK, q_ss, q0, s);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  bf16* q_rot_row = q_rot == nullptr ? nullptr : q_rot + ((long long)row * s * heads + h) * ROPE;
  rotate<NOPE, ROPE, D::KS>(kst(1), q0, s, cos, sin, q_rot_row, (long long)heads * ROPE, s);
  rotate<NOPE, ROPE, D::KS>(kst(0), 0, s, cos, sin, k_rot_row, ROPE, key_end);
  __syncthreads();

  unsigned qa[KSTEPS][4];
  {
    const bf16* qs = kst(1) + (warp * 16 + (lane & 15)) * D::KS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qa[kk], qs + kk * 16);
  }
  __syncthreads();  // stage 1 is free for the second K / V tile

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's two query rows
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_kv(st ^ 1, (it + 1) * BK);
    cp_async_commit();

    const bf16* kt = kst(st);
    const bf16* vt = vst(st);
    const int key0 = it * BK;
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    {
      // k-steps outside, key blocks inside: consecutive products go to
      // different accumulators
      const int mrow = lane & 7, mcol = (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          unsigned b[4];
          ldmatrix_x4(b, kt + (n * 8 + mrow) * D::KS + kk * 16 + mcol);
          mma_bf16(sc[n], qa[kk], b[0], b[1]);
          mma_bf16(sc[n], qa[kk + 1], b[2], b[3]);
        }
      }
    }
    // masks, only where this warp's rows meet the diagonal, an invalid key or
    // a query without an allowed key: c0 / c1 are row ra, keys 2t / 2t + 1 of
    // each 8-key block; c2 / c3 row rb
    if (uniform || key0 + BK - 1 > q0 + warp * 16 || tile_valid[it] != BK) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t + (e & 1);
          const int qrow = e < 2 ? ra : rb;
          float v = key <= qrow && keep[key] ? sc[n][e] : NEG_INF;  // causal or padding
          if (qrow < first) v = key < s ? 0.0f : -INFINITY;          // no allowed key: uniform
          sc[n][e] = v;
        }
      }
    }
    // online softmax in the exp2 domain (scores in raw units, the scale folded in)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_next) * scale_log2);
      m[r] = m_next;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f((sc[n][e] - m[e >> 1]) * scale_log2);
        psum[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P's A fragment is the S fragment of two key blocks, in bf16
    {
      const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + vkey) * D::VS + n * 8 + vcol);
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // the next tile has landed and every warp is done with this one
    if (it + 1 < n_tiles) {
      rotate<NOPE, ROPE, D::KS>(kst(st ^ 1), (it + 1) * BK, s, cos, sin, k_rot_row, ROPE, key_end);
      __syncthreads();
    }
  }

  // normalise: by the row's sum, or for a query without an allowed key by
  // bf16(1 / s) (its sum is then that of v over all s keys)
  const float uniform_p = __bfloat162float(__float2bfloat16(1.0f / (float)s));
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = (r == 0 ? ra : rb) < first ? uniform_p : 1.0f / l[r];
  }
  const long long o_ss = (long long)heads * VD;
  bf16* orow = out + (long long)row * s * o_ss + (long long)h * VD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= VD) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = r == 0 ? ra : rb;
      if (qrow < s)
        *reinterpret_cast<unsigned*>(orow + qrow * o_ss + col) =
            pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NOPE, int ROPE, int VD>
cudaError_t launch(const void* q, long long q_sb, long long q_ss, const void* k_pe,
                   long long kpe_sb, long long kpe_ss, const void* kv, long long kv_sb,
                   long long kv_ss, const float* cos, const float* sin, const void* mask,
                   long long mask_sb, void* out, void* q_rot, void* k_rot, int b, int heads,
                   int s, float sm_scale, cudaStream_t stream) {
  using D = Dims<NOPE, ROPE, VD>;
  auto kernel = mla_attention_kernel<NOPE, ROPE, VD>;
  int max_smem = 0;
  const cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  // no static shared memory: the opt-in maximum is for dynamic memory alone
  const size_t smem = D::TILE_BYTES + (size_t)tail_bytes(s);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)heads, (unsigned)b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), q_sb, q_ss, static_cast<const bf16*>(k_pe), kpe_sb, kpe_ss,
      static_cast<const bf16*>(kv), kv_sb, kv_ss, cos, sin,
      static_cast<const unsigned char*>(mask), mask_sb, static_cast<bf16*>(out),
      static_cast<bf16*>(q_rot), static_cast<bf16*>(k_rot), heads, s, sm_scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides in elements.  (nope, rope, vd): (128, 64, 128), the published
// DeepSeek-V3 / Moonlight widths, or (16, 8, 16), the tests' tiny tower.
// Returns a cudaError_t (0 = success).
int mmg_mla_attention(const void* q, long long q_sb, long long q_ss, const void* k_pe,
                      long long kpe_sb, long long kpe_ss, const void* kv, long long kv_sb,
                      long long kv_ss, const float* cos, const float* sin, const void* mask,
                      long long mask_sb, void* out, void* q_rot, void* k_rot, int b, int heads,
                      int s, int nope, int rope, int vd, float sm_scale, void* stream) {
  if (b <= 0 || b > 65535 || heads <= 0 || heads > 65535 || s <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k_pe) || !aligned16(kv) || !aligned16(out) || !aligned16(cos) ||
      !aligned16(sin) || (cos == nullptr) != (sin == nullptr) ||
      (q_sb | q_ss | kpe_sb | kpe_ss | kv_sb | kv_ss) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nope == 128 && rope == 64 && vd == 128)
    return (int)launch<128, 64, 128>(q, q_sb, q_ss, k_pe, kpe_sb, kpe_ss, kv, kv_sb, kv_ss, cos,
                                     sin, mask, mask_sb, out, q_rot, k_rot, b, heads, s, sm_scale,
                                     st);
  if (nope == 16 && rope == 8 && vd == 16)
    return (int)launch<16, 8, 16>(q, q_sb, q_ss, k_pe, kpe_sb, kpe_ss, kv, kv_sb, kv_ss, cos, sin,
                                  mask, mask_sb, out, q_rot, k_rot, b, heads, s, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
