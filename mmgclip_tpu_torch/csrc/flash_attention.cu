// Online-softmax (flash) attention with per-row valid key lengths, for sm_90a.
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/flash_attention.py
// (`_flash_call` / `_flash_kernel`).  Same contract:
//   * q, k, v, o are [b, heads, s, d] contiguous, float or bf16; lens [b]
//     int32 gives each batch row's valid key PREFIX length;
//   * scores = (q . k) * sm_scale in fp32; keys at or past the valid length
//     score NEG_INF = -1e30; the running (m, l, acc) state is fp32;
//   * key tiles wholly past the valid length are skipped; a row with
//     valid length 0 keeps the full loop, which gives uniform weights over
//     all s keys (every score is NEG_INF), not NaN;
//   * p is rounded to v's dtype before the PV product, l sums the unrounded
//     p, and the output is acc / max(l, 1e-30).
// The TPU tiling floor (s >= 128, multiples of 8) does not carry over: any s
// and any d <= 128 run here, so pad-trimmed prompt banks (s = 32) use it.
//
// Design.  One CTA of BQ threads per (b*heads, q tile); each thread owns one
// query row and keeps q and acc in registers.  K and V tiles of BK keys are
// staged in shared memory as fp32 (zero-filled past s and past d); every
// thread reads the same key row, so the reads broadcast.  What bounds it:
// the two [s, d] x [d, s]-class products are 4*s*valid*d operations per
// (b, head), run as fp32 FMAs, so it is bound by operations at BERT sizes;
// tensor cores are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(BQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lens,
             T* __restrict__ o, int heads, int s, int d, float sm_scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < s;
  const int valid = lens[bh / heads];
  const long long base = (long long)bh * s * d;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = (active && i < d) ? to_f<T>(q[base + (long long)row * d + i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = NEG_INF;
  float l = 0.0f;

  // keys to visit: the tiles that hold the valid prefix, or all s keys
  // when the row has no valid key
  const int limit = valid > 0 ? min(valid, s) : s;
  const int ntiles = (limit + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < BK * D; e += BQ) {
      const int kk = e / D;
      const int dd = e - kk * D;
      const int key = k0 + kk;
      float kv = 0.0f, vv = 0.0f;
      if (key < s && dd < d) {
        const long long at = base + (long long)key * d + dd;
        kv = to_f<T>(k[at]);
        vv = to_f<T>(v[at]);
      }
      ks[kk][dd] = kv;
      vs[kk][dd] = vv;
    }
    __syncthreads();
    if (!active) continue;

    float sc[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[kk][0]);
      float dot = 0.0f;
#pragma unroll
      for (int i4 = 0; i4 < D / 4; ++i4) {
        const float4 kv = kr[i4];
        dot += qr[4 * i4 + 0] * kv.x;
        dot += qr[4 * i4 + 1] * kv.y;
        dot += qr[4 * i4 + 2] * kv.z;
        dot += qr[4 * i4 + 3] * kv.w;
      }
      const int key = k0 + kk;
      float sv = dot * sm_scale;
      if (key >= s) sv = -INFINITY;     // not a key at all
      else if (key >= valid) sv = NEG_INF;  // padding key
      sc[kk] = sv;
      tile_max = fmaxf(tile_max, sv);
    }
    const float m_next = fmaxf(m, tile_max);
    const float alpha = expf(m - m_next);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= alpha;
    float psum = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float p = expf(sc[kk] - m_next);
      psum += p;
      const float pv = round_to<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(&vs[kk][0]);
#pragma unroll
      for (int i4 = 0; i4 < D / 4; ++i4) {
        const float4 vv = vr[i4];
        acc[4 * i4 + 0] += pv * vv.x;
        acc[4 * i4 + 1] += pv * vv.y;
        acc[4 * i4 + 2] += pv * vv.z;
        acc[4 * i4 + 3] += pv * vv.w;
      }
    }
    l = alpha * l + psum;
    m = m_next;
  }

  if (active) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i)
      if (i < d) o[base + (long long)row * d + i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens,
                   void* o, int b, int heads, int s, int d, float sm_scale,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)(b * heads));
  flash_kernel<T, D, BK><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), heads, s, d, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lens, void* o, int b, int heads, int s, int d,
                     float sm_scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64, 32>(q, k, v, lens, o, b, heads, s, d, sm_scale, stream);
  return launch<T, 128, 16>(q, k, v, lens, o, b, heads, s, d, sm_scale, stream);
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

const char* mmg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
