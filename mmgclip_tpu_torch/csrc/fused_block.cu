// One whole ConvNeXt block in one kernel, for sm_90a:
//
//     out = x + gamma * pw2(GELU(pw1(LN(dwconv7x7(x) + dw_bias))))
//
// Replaces the Pallas TPU kernels of mmgclip_tpu/ops/fused_block.py
// (`_fused_call` / `_kernel`, and the row-banded `_fused_call_banded` /
// `_kernel_banded` with its `_pad_to_band` padding): on this card one grid
// covers all three TPU routes, because a CTA reads its 7x7 halo straight from
// device memory with a bounds check (SAME padding) instead of staging a
// whole image or band in fast memory.
//
// Layout: x / out [n, H, W, C] (NHWC, contiguous); dwk [7, 7, 1, C] (HWIO);
// w1 [C, 4C]; w2 [4C, C]; dwb, b2, gamma [C]; b1 [4C]; the LayerNorm affine
// ns / nb [C] is always fp32.  T is float or __nv_bfloat16.
//
// Design.  One CTA owns P consecutive pixels of the flattened n*H*W pixel
// range across all C channels:
//   (a) the 49 depthwise taps accumulate in fp32 (out-of-image taps are
//       skipped, which is SAME zero padding), plus the bias;
//   (b) LayerNorm over C per pixel in fp32, eps 1e-6, one warp per pixel;
//       the result is rounded to T (the JAX kernel casts to the weight dtype
//       before pw1);
//   (c) the 4C hidden units run in chunks of JCHUNK: h = GELU(y . w1[:, j] +
//       b1[j]) rounded to T, then out += h . w2[j, :] in fp32, so the 4C-wide
//       intermediate never exists whole and never reaches device memory;
//   (d) x + gamma * (out + b2), stored in T.
// What bounds it: the two pointwise products are ~16*C^2 of the block's
// ~16*C^2 + 98*C operations per pixel, and they run here as plain fp32 FMA
// loops, so it is bound by operations (and, below that, by shared-memory
// loads feeding the FMAs), not by the 2*C*sizeof(T) bytes per pixel it has
// to move.  Tensor cores (wgmma), TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int THREADS = 256;
constexpr int JCHUNK = 64;                 // hidden units per chunk
constexpr int GROUPS = THREADS / JCHUNK;   // pixel groups in the pw1 phase

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

__device__ __forceinline__ float gelu(float x, int tanh_approx) {
  if (tanh_approx) {
    const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
    const float c1 = 0.044715f;
    return 0.5f * x * (1.0f + tanhf(c0 * (x + c1 * x * x * x)));
  }
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
fused_block_kernel(const T* __restrict__ x, const T* __restrict__ dwk,
                   const T* __restrict__ dwb, const float* __restrict__ ns,
                   const float* __restrict__ nb, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, const T* __restrict__ gamma,
                   T* __restrict__ out, int n, int h, int w, int c, float eps,
                   int gelu_tanh) {
  constexpr int PT = P / GROUPS;  // pixels per thread in both products
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;            // [P][c]: dwconv output, then LN output
  float* acc = ys + P * c;     // [P][c]: pw2 accumulator
  float* hid = acc + P * c;    // [P][JCHUNK]: one chunk of GELU(pw1)

  const long long hw = (long long)h * w;
  const long long total = (long long)n * hw;
  const long long pix0 = (long long)blockIdx.x * P;
  const int tid = threadIdx.x;
  const int c4 = 4 * c;

  // (a) depthwise 7x7 + bias, fp32 accumulation, SAME padding by bounds check
  for (int idx = tid; idx < P * c; idx += THREADS) {
    const int p = idx / c;
    const int ch = idx - p * c;
    const long long pix = pix0 + p;
    float s = 0.0f;
    if (pix < total) {
      const long long img = pix / hw;
      const long long rem = pix - img * hw;
      const int py = (int)(rem / w);
      const int px = (int)(rem - (long long)py * w);
      const T* xb = x + img * hw * c + ch;
      for (int ky = 0; ky < KS; ++ky) {
        const int yy = py + ky - HALO;
        if (yy < 0 || yy >= h) continue;
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          const int xx = px + kx - HALO;
          if (xx < 0 || xx >= w) continue;
          s += to_f<T>(xb[((long long)yy * w + xx) * c]) *
               to_f<T>(dwk[(ky * KS + kx) * c + ch]);
        }
      }
      s += to_f<T>(dwb[ch]);
    }
    ys[idx] = s;
    acc[idx] = 0.0f;
  }
  __syncthreads();

  // (b) LayerNorm over C, one warp per pixel, two-pass fp32 statistics
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int p = warp; p < P; p += THREADS / 32) {
    float* row = ys + p * c;
    float sum = 0.0f;
    for (int ch = lane; ch < c; ch += 32) sum += row[ch];
    const float mean = warp_sum(sum) / (float)c;
    float sq = 0.0f;
    for (int ch = lane; ch < c; ch += 32) {
      const float d = row[ch] - mean;
      sq += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)c + eps);
    for (int ch = lane; ch < c; ch += 32)
      row[ch] = round_to<T>((row[ch] - mean) * rstd * ns[ch] + nb[ch]);
  }
  __syncthreads();

  // (c) the MLP, JCHUNK hidden units at a time
  const int jj = tid % JCHUNK;
  const int pg = tid / JCHUNK;
  for (int j0 = 0; j0 < c4; j0 += JCHUNK) {
    // pw1 + b1 + GELU: thread (pg, jj) computes hidden unit j0+jj for the
    // PT pixels of group pg; a warp shares pg, so the ys reads broadcast and
    // the w1 reads coalesce over jj
    {
      const int j = j0 + jj;
      float a[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = 0.0f;
      if (j < c4) {
        for (int ch = 0; ch < c; ch += 4) {
          const float w0 = to_f<T>(w1[(long long)(ch + 0) * c4 + j]);
          const float wa = to_f<T>(w1[(long long)(ch + 1) * c4 + j]);
          const float wb = to_f<T>(w1[(long long)(ch + 2) * c4 + j]);
          const float wc = to_f<T>(w1[(long long)(ch + 3) * c4 + j]);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const float4 yv =
                *reinterpret_cast<const float4*>(ys + (pg * PT + i) * c + ch);
            a[i] += yv.x * w0;
            a[i] += yv.y * wa;
            a[i] += yv.z * wb;
            a[i] += yv.w * wc;
          }
        }
        const float bj = to_f<T>(b1[j]);
#pragma unroll
        for (int i = 0; i < PT; ++i)
          hid[(pg * PT + i) * JCHUNK + jj] = round_to<T>(gelu(a[i] + bj, gelu_tanh));
      } else {
#pragma unroll
        for (int i = 0; i < PT; ++i) hid[(pg * PT + i) * JCHUNK + jj] = 0.0f;
      }
    }
    __syncthreads();

    // pw2: item (g2, ch) adds the chunk's contribution to acc for the PT
    // pixels of group g2 at channel ch; consecutive threads take consecutive
    // channels, so w2 reads coalesce and hid reads broadcast
    const int jn = min(JCHUNK, c4 - j0);  // a multiple of 4 since c % 4 == 0
    for (int item = tid; item < GROUPS * c; item += THREADS) {
      const int g2 = item / c;
      const int ch = item - g2 * c;
      float a[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = 0.0f;
      for (int j = 0; j < jn; j += 4) {
        const float w0 = to_f<T>(w2[(long long)(j0 + j + 0) * c + ch]);
        const float wa = to_f<T>(w2[(long long)(j0 + j + 1) * c + ch]);
        const float wb = to_f<T>(w2[(long long)(j0 + j + 2) * c + ch]);
        const float wc = to_f<T>(w2[(long long)(j0 + j + 3) * c + ch]);
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hid + (g2 * PT + i) * JCHUNK + j);
          a[i] += hv.x * w0;
          a[i] += hv.y * wa;
          a[i] += hv.z * wb;
          a[i] += hv.w * wc;
        }
      }
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[(g2 * PT + i) * c + ch] += a[i];
    }
    __syncthreads();
  }

  // (d) layer scale + residual, one store in T
  for (int idx = tid; idx < P * c; idx += THREADS) {
    const int p = idx / c;
    const int ch = idx - p * c;
    const long long pix = pix0 + p;
    if (pix < total) {
      const long long at = pix * c + ch;
      const float o = (acc[idx] + to_f<T>(b2[ch])) * to_f<T>(gamma[ch]);
      out[at] = from_f<T>(to_f<T>(x[at]) + o);
    }
  }
}

size_t smem_bytes(int p, int c) {
  return (size_t)(2 * p * c + p * JCHUNK) * sizeof(float);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dwk, const void* dwb,
                   const float* ns, const float* nb, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* gamma, void* out, int n, int h, int w, int c,
                   float eps, int gelu_tanh, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, c);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * h * w;
  const unsigned blocks = (unsigned)((total + P - 1) / P);
  fused_block_kernel<T, P><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dwk),
      static_cast<const T*>(dwb), ns, nb, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(gamma),
      static_cast<T*>(out), n, h, w, c, eps, gelu_tanh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int p, const void* x, const void* dwk, const void* dwb,
                     const float* ns, const float* nb, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, int n, int h, int w, int c,
                     float eps, int gelu_tanh, cudaStream_t stream) {
  switch (p) {
    case 8:
      return launch<T, 8>(x, dwk, dwb, ns, nb, w1, b1, w2, b2, gamma, out, n,
                          h, w, c, eps, gelu_tanh, stream);
    case 16:
      return launch<T, 16>(x, dwk, dwb, ns, nb, w1, b1, w2, b2, gamma, out, n,
                           h, w, c, eps, gelu_tanh, stream);
    case 32:
      return launch<T, 32>(x, dwk, dwb, ns, nb, w1, b1, w2, b2, gamma, out, n,
                           h, w, c, eps, gelu_tanh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pixels per CTA: the largest of 32 and
// 16 whose shared memory fits and that still gives every SM two CTAs of
// work, else 8.  Returns a cudaError_t (0 = success).
int mmg_fused_block(int dtype, const void* x, const void* dwk, const void* dwb,
                    const float* ns, const float* nb, const void* w1,
                    const void* b1, const void* w2, const void* b2,
                    const void* gamma, void* out, int n, int h, int w, int c,
                    float eps, int gelu_tanh, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)n * h * w;
  int tile_p = 8;
  const int choices[2] = {32, 16};
  for (int k = 0; k < 2; ++k) {
    const int p = choices[k];
    if (smem_bytes(p, c) <= (size_t)max_smem && (pixels + p - 1) / p >= 2LL * sms) {
      tile_p = p;
      break;
    }
  }
  if (smem_bytes(tile_p, c) > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(tile_p, x, dwk, dwb, ns, nb, w1, b1, w2, b2,
                                gamma, out, n, h, w, c, eps, gelu_tanh, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(tile_p, x, dwk, dwb, ns, nb, w1, b1, w2,
                                        b2, gamma, out, n, h, w, c, eps,
                                        gelu_tanh, s);
  return (int)cudaErrorInvalidValue;
}

const char* mmg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
