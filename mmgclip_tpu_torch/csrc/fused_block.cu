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

#include "common.cuh"

namespace {

using namespace mmg;

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int THREADS = 256;
constexpr int JCHUNK = 64;                 // hidden units per chunk
constexpr int GROUPS = THREADS / JCHUNK;   // pixel groups in the pw1 phase

// (a) of both kernels: the 49 depthwise taps of pixel `pix`, channel `ch`,
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
    ys[idx] = pix < total ? dwconv_at<T>(x, dwk, dwb, pix, ch, h, w, c) : 0.0f;
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
