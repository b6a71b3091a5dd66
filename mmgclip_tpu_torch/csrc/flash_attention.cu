// Online-softmax (flash) attention with per-row valid key lengths, for sm_90a.
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/flash_attention.py
// (`_flash_call` / `_flash_kernel`).  Same contract:
//   * q, k, v, o are [b, heads, s, d] contiguous, float or bf16; lens [b]
//     int32 gives each batch row's valid key PREFIX length;
//   * scores = (q . k) * sm_scale in fp32; keys at or past the valid length
//     score NEG_INF = -1e30; the running (m, l, acc) state is fp32;
//   * key tiles wholly past the valid length are skipped, loads and
//     compute; a row with valid length 0 keeps the full loop, which gives
//     uniform weights over all s keys (every score is NEG_INF), not NaN;
//   * p is rounded to v's dtype before the PV product, l sums the unrounded
//     p, and the output is acc / max(l, 1e-30).
// The TPU tiling floor (s >= 128, multiples of 8) does not carry over: any s
// and any d <= 128 run here, so pad-trimmed prompt banks (s = 32) use it.
//
// What bounds it on an H100: 4 * s * keys * d operations per (b, head)
// against 2 * (s + keys) * d elements moved, so operations at BERT sizes
// (s = 32 .. 256, d = 64) and latency at the smallest.  The products must
// reach the tensor cores: fp32 FMAs alone (67 TFLOP/s) lose to PyTorch's own
// attention, which runs on them.
//
// Design (FlashAttention-2 shape, mma.sync):
//   * A warp owns 16 query rows of one (b, head); a CTA holds W warps of one
//     pair (W = 1, 2, 4 for s <= 16, <= 32, more) and G = 4 / W pairs, so at
//     s = 32 both warps of a pair work and a CTA holds two pairs.  The CTA's
//     key-tile loop runs to the longest of its pairs; a pair past its own
//     valid tiles neither loads nor computes.
//   * K and V tiles of 32 keys go to shared memory with 16-byte cp.async,
//     double-buffered, zero-filled past s and past d (d is padded to 64 or
//     128, so d = 40 runs); rows are padded so fragment reads are free of
//     bank conflicts.  Rows whose d * sizeof(T) is not a multiple of 16 bytes
//     take plain loads into the same buffers.
//   * bf16: S = Q K^T by mma.m16n8k16 (bf16 in, fp32 accumulate), K
//     fragments by ldmatrix, Q fragments in registers.  The online softmax
//     runs on the S fragment (row max across the quad by shuffles), p is
//     rounded to bf16 in registers and fed straight to the PV mma as its A
//     operand; V fragments by ldmatrix.trans.
//   * fp32: the same structure with mma.m16n8k8 TF32 in a three-pass split,
//     a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi with x_hi = tf32(x) and
//     x_lo = tf32(x - x_hi): the dropped a_lo * b_lo term is ~2^-22 of the
//     product, the error of an fp32 FMA chain.  PyTorch's fp32 attention
//     takes the same route.  ldmatrix moves 16-bit elements only, so the fp32
//     fragments are plain 32-bit shared loads (conflict free by the padding),
//     and the PV A operand takes the keys in the order the S fragment holds
//     them (the sum over keys does not care), so p never leaves registers.
//     Measured on an H100 80GB HBM3 (chip_smoke.py phase 4): at most 3.1e-6
//     absolute against attention_reference at b=8, 12 heads, s=256, d=64 and
//     2.1e-6 at s=32, inside the 1e-5 bound (the FFMA kernel this design
//     replaced measured 9.5e-7).  d = 128 in fp32 spills 248 bytes a thread
//     (Q and O fragments fill the registers); d <= 64 does not spill.

#include "common.cuh"

#include <math.h>
#include <type_traits>

namespace {

using namespace mmg;

constexpr int BK = 32;          // keys per tile
constexpr int ROWS = 16;        // query rows per warp (the mma's M)
constexpr int MAX_WARPS = 4;    // warps per CTA
constexpr float NEG_INF = -1e30f;

// shared-memory row stride of a K / V tile, in elements
template <typename T, int DP> __host__ __device__ constexpr int stride() {
  return DP + (sizeof(T) == 2 ? 8 : 4);
}
// elements of one group's buffers: 2 stages x (K, V) x BK rows
template <typename T, int DP> __host__ __device__ constexpr int group_elems() {
  return 4 * BK * stride<T, DP>();
}

__device__ __forceinline__ unsigned short bf16_bits(__nv_bfloat16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

// One group's K and V tile of keys [key0, key0 + BK) into (ks, vs).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* __restrict__ k,
                                          const T* __restrict__ v, long long base, int key0,
                                          int s, int d, bool vec16, int tid, int nthreads) {
  constexpr int S = stride<T, DP>();
  if (vec16) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int PER_ROW = DP / E;
    for (int i = tid; i < BK * PER_ROW; i += nthreads) {
      const int r = i / PER_ROW;
      const int col = (i - r * PER_ROW) * E;
      const int key = key0 + r;
      const bool ok = key < s && col < d;  // d * sizeof(T) % 16 == 0: no chunk straddles d
      const long long at = ok ? base + (long long)key * d + col : 0;
      cp_async16(ks + r * S + col, k + at, ok ? 16 : 0);
      cp_async16(vs + r * S + col, v + at, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BK * DP; i += nthreads) {
      const int r = i / DP;
      const int col = i - r * DP;
      const int key = key0 + r;
      T kv = from_f<T>(0.0f), vv = from_f<T>(0.0f);
      if (key < s && col < d) {
        const long long at = base + (long long)key * d + col;
        kv = k[at];
        vv = v[at];
      }
      ks[r * S + col] = kv;
      vs[r * S + col] = vv;
    }
  }
}

// The online-softmax update of one tile's scores sc (the S fragment, already
// scaled and masked): new running max m, rescale of acc and of the partial
// row sums l (this thread's columns only; the quad is summed at the end).
template <int NT>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[NT][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_next = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_next);
    m[r] = m_next;
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = expf(sc[n][e] - m[e >> 1]);
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
}

// scale and mask one tile's raw products: c0/c1 are row g, keys 2t / 2t + 1
// of each 8-key column block; c2/c3 row g + 8
__device__ __forceinline__ void scale_mask(float (&sc)[BK / 8][4], int key0, int s, int valid,
                                           float sm_scale, int t) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + n * 8 + 2 * t + (e & 1);
      float sv = sc[n][e] * sm_scale;
      if (key >= s) sv = -INFINITY;          // not a key at all
      else if (key >= valid) sv = NEG_INF;   // padding key
      sc[n][e] = sv;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ lens, T* __restrict__ o, int pairs, int heads, int s, int d,
             float sm_scale, int warps_per_pair, int groups, int vec16) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int S = stride<T, DP>();
  constexpr int NT = DP / 8;  // 8-column output blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / warps_per_pair;
  const int pair = blockIdx.x * groups + group;
  const int row0 = (blockIdx.y * warps_per_pair + warp % warps_per_pair) * ROWS;
  const int gthreads = 32 * warps_per_pair;
  const int gtid = threadIdx.x - group * gthreads;

  // key tiles to visit: the tiles that hold the valid prefix, or all s keys
  // when the row has no valid key; the CTA loops to its longest pair
  auto tiles_of = [&](int p) {
    if (p >= pairs) return 0;
    const int valid = lens[p / heads];
    const int limit = valid > 0 ? min(valid, s) : s;
    return (limit + BK - 1) / BK;
  };
  int cta_tiles = 0;
  for (int gi = 0; gi < groups; ++gi) cta_tiles = max(cta_tiles, tiles_of(blockIdx.x * groups + gi));
  const int my_tiles = tiles_of(pair);
  const int valid = pair < pairs ? lens[pair / heads] : 0;
  const bool computes = pair < pairs && row0 < s;
  const long long base = (long long)min(pair, pairs - 1) * s * d;

  T* buf = reinterpret_cast<T*>(smem_raw) + (size_t)group * group_elems<T, DP>();
  auto ks = [&](int stage) { return buf + stage * 2 * BK * S; };
  auto vs = [&](int stage) { return buf + (stage * 2 + 1) * BK * S; };

  // Q fragments, straight from device memory (rows >= s and columns >= d are 0)
  constexpr int QK = BF16 ? DP / 16 : DP / 8;  // k-steps of S = Q K^T
  unsigned qb[BF16 ? QK : 1][4];               // bf16: packed pairs
  float qf[BF16 ? 1 : QK][4];                  // fp32: raw, split per use
  {
    const T* qr = q + base;
    auto qat = [&](int row, int col) -> T {
      return (row < s && col < d) ? qr[(long long)row * d + col] : from_f<T>(0.0f);
    };
    const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      if constexpr (BF16) {
        const int c = kk * 16 + 2 * t;
        auto pack = [&](int row, int col) {
          return (unsigned)bf16_bits(qat(row, col)) | ((unsigned)bf16_bits(qat(row, col + 1)) << 16);
        };
        qb[kk][0] = pack(ra, c);
        qb[kk][1] = pack(rb, c);
        qb[kk][2] = pack(ra, c + 8);
        qb[kk][3] = pack(rb, c + 8);
      } else {
        const int c = kk * 8 + t;
        qf[kk][0] = to_f<T>(qat(ra, c));
        qf[kk][1] = to_f<T>(qat(rb, c));
        qf[kk][2] = to_f<T>(qat(ra, c + 4));
        qf[kk][3] = to_f<T>(qat(rb, c + 4));
      }
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  if (my_tiles > 0) load_tile<T, DP>(ks(0), vs(0), k, v, base, 0, s, d, vec16, gtid, gthreads);
  cp_async_commit();
  for (int it = 0; it < cta_tiles; ++it) {
    const bool more = it + 1 < cta_tiles;
    if (more) {
      if (it + 1 < my_tiles)
        load_tile<T, DP>(ks((it + 1) & 1), vs((it + 1) & 1), k, v, base, (it + 1) * BK, s, d,
                         vec16, gtid, gthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (computes && it < my_tiles) {
      const T* kt = ks(it & 1);
      const T* vt = vs(it & 1);
      const int key0 = it * BK;
      float sc[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;

      if constexpr (BF16) {
        // S: per 8-key block n, ldmatrix.x4 gives the B fragments of two k-steps
        const int mrow = lane & 7, mcol = (lane >> 3) * 8;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int kk = 0; kk < QK; kk += 2) {
            unsigned b[4];
            ldmatrix_x4(b, kt + (n * 8 + mrow) * S + kk * 16 + mcol);
            mma_bf16(sc[n], qb[kk], b[0], b[1]);
            mma_bf16(sc[n], qb[kk + 1], b[2], b[3]);
          }
        }
        scale_mask(sc, key0, s, valid, sm_scale, t);
        softmax_step<NT>(sc, m, l, acc);
        // O += P V: P's A fragment is the S fragment of two key blocks,
        // rounded to bf16; V's B fragments by ldmatrix.trans
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
            ldmatrix_x4_trans(b, vt + (kk * 16 + vkey) * S + n * 8 + vcol);
            mma_bf16(acc[n], a, b[0], b[1]);
            mma_bf16(acc[n + 1], a, b[2], b[3]);
          }
        }
      } else {
        // S: per k-step split Q once, then each 8-key block's K fragment
#pragma unroll
        for (int kk = 0; kk < QK; ++kk) {
          unsigned ahi[4], alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(qf[kk][e], ahi[e], alo[e]);
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const float* kr = reinterpret_cast<const float*>(kt) + (n * 8 + g) * S + kk * 8 + t;
            unsigned bh0, bl0, bh1, bl1;
            split(kr[0], bh0, bl0);
            split(kr[4], bh1, bl1);
            mma_3xtf32(sc[n], ahi, alo, bh0, bh1, bl0, bl1);
          }
        }
        scale_mask(sc, key0, s, valid, sm_scale, t);
        softmax_step<NT>(sc, m, l, acc);
        // O += P V over each 8-key block j, k index t <-> key 2t and
        // t + 4 <-> key 2t + 1, the keys this thread's S fragment holds
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          unsigned ahi[4], alo[4];
          split(sc[j][0], ahi[0], alo[0]);
          split(sc[j][2], ahi[1], alo[1]);
          split(sc[j][1], ahi[2], alo[2]);
          split(sc[j][3], ahi[3], alo[3]);
          const float* v0 = reinterpret_cast<const float*>(vt) + (j * 8 + 2 * t) * S + g;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            unsigned bh0, bl0, bh1, bl1;
            split(v0[n * 8], bh0, bl0);
            split(v0[S + n * 8], bh1, bl1);
            mma_3xtf32(acc[n], ahi, alo, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
  if (!computes) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
  T* orow = o + base;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >> 1) * 8;
      const int col = n * 8 + 2 * t + (e & 1);
      if (row < s && col < d) orow[(long long)row * d + col] = from_f<T>(acc[n][e] * inv[e >> 1]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens, void* o, int b,
                   int heads, int s, int d, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, DP>;
  int max_smem = 0;
  const cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  const int w = s <= 16 ? 1 : (s <= 32 ? 2 : MAX_WARPS);
  const size_t per_group = (size_t)group_elems<T, DP>() * sizeof(T);
  int groups = MAX_WARPS / w;
  while (groups > 1 && groups * per_group > (size_t)max_smem) groups /= 2;
  const long long pairs = (long long)b * heads;
  if (pairs > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 16-byte copies need every row, and so d * sizeof(T) and each base, on 16 bytes
  const bool vec16 = (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((unsigned)((pairs + groups - 1) / groups),
                  (unsigned)((s + ROWS * w - 1) / (ROWS * w)));
  kernel<<<grid, 32 * w * groups, groups * per_group, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(o), (int)pairs, heads, s, d, sm_scale, w, groups, vec16 ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* lens, void* o, int b,
                     int heads, int s, int d, float sm_scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, lens, o, b, heads, s, d, sm_scale, stream);
  return launch<T, 128>(q, k, v, lens, o, b, heads, s, d, sm_scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int mmg_flash_attention(int dtype, const void* q, const void* k, const void* v,
                        const int* lens, void* o, int b, int heads, int s, int d,
                        float sm_scale, void* stream) {
  if (b <= 0 || heads <= 0 || s <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, lens, o, b, heads, s, d, sm_scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, lens, o, b, heads, s, d, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
