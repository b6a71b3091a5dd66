// Helpers shared by the ConvNeXt kernels (fused_block.cu, fused_stem.cu,
// fused_downsample.cu, depthwise_conv.cu).  Each source still builds into its
// own shared library; ops/_build.py hashes this header into every library's
// key, so a change here rebuilds them all.
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
