// Helpers shared by the kernels (fused_block.cu, fused_stem.cu,
// fused_downsample.cu, depthwise_conv.cu / depthwise_tile.cuh,
// flash_attention.cu; ring_all_gather.cu takes only the error-string
// export), among them the tensor-core fragments of flash_attention.cu,
// fused_block.cu's ln_mlp and ln_mlp_int8 and fused_downsample.cu.  Each source still builds into its own
// shared library; ops/_build.py hashes every csrc/*.cuh into every
// library's key, so a change here rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mmg {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// round an fp32 value to T's precision (a no-op for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// two consecutive values of T (4- or 8-byte aligned) as a float2
template <typename T> __device__ __forceinline__ float2 load_pair(const T* p);
template <> __device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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
// two floats -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float gelu(float x, int tanh_approx) {
  if (tanh_approx) {
    const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
    const float c1 = 0.044715f;
    return 0.5f * x * (1.0f + tanhf(c0 * (x + c1 * x * x * x)));
  }
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Two-pass LayerNorm statistics of one row held by a whole warp (each lane
// reads row[lane], row[lane + 32], ...): returns (mean, 1 / sqrt(var + eps)).
__device__ __forceinline__ float2 warp_row_stats(const float* row, int n, float eps) {
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  for (int i = lane; i < n; i += 32) sum += row[i];
  const float mean = warp_sum(sum) / (float)n;
  float sq = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float d = row[i] - mean;
    sq += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)n + eps);
  return make_float2(mean, rstd);
}

// 16-byte asynchronous copy into shared memory; the bytes past ``src_bytes``
// (all 16 when it is 0) are zero-filled, so a tile's padding costs no read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- tensor cores (mma.sync) ------------------------------------------
// Fragment layouts of m16n8k16 (bf16) and m16n8k8 (tf32), lane = 4 * g + t:
// A a0..a3 = (row g, k lo), (row g + 8, k lo), (row g, k hi), (row g + 8,
// k hi); B b0, b1 = (k lo, column g), (k hi, column g); C c0, c1 = row g,
// columns 2t, 2t + 1 and c2, c3 = row g + 8.  bf16: k lo = 2t, 2t + 1 and
// k hi = 8 + 2t, 9 + 2t (pairs packed in one register); tf32: k lo = t and
// k hi = t + 4.

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (tf32(x), tf32(x - tf32(x)))
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// three-pass TF32 product: small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], unsigned bhi0,
                                           unsigned bhi1, unsigned blo0, unsigned blo1) {
  mma_tf32(c, alo, bhi0, bhi1);
  mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k32 in int8 with exact int32 sums.  Fragments by 32-bit words of four
// int8 (the lowest byte first): A a0..a3 = (row g, k 4t..4t+3), (row g + 8,
// the same k), (row g, k 16 + 4t..), (row g + 8, k 16 + 4t..), which is the
// bf16 A layout read as bytes (ldmatrix serves it); B b0 = (k 4t..4t+3,
// column g), b1 = (k 16 + 4t.., column g); C as above, in int32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// Raise a kernel's dynamic shared memory limit on the current device to the
// opt-in maximum, which it stores in ``max_smem`` (bytes).
template <typename Kernel>
inline cudaError_t allow_max_smem(Kernel kernel, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  return err;
}

// Largest tile (of the candidates, in order) whose shared memory fits and that
// still gives every SM two CTAs of work; else the last candidate.  -1 when
// even that does not fit.
template <typename SmemFn>
inline int pick_tile(const int* candidates, int count, long long items, SmemFn smem) {
  int dev = 0, max_smem = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  for (int k = 0; k < count; ++k) {
    const int p = candidates[k];
    if (smem(p) <= (size_t)max_smem && (items + p - 1) / p >= 2LL * sms) return p;
  }
  const int last = candidates[count - 1];
  return smem(last) <= (size_t)max_smem ? last : -1;
}

}  // namespace mmg

extern "C" const char* mmg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
