// Depthwise 7x7 convolution, stride 1, SAME zero padding, plus bias, for
// sm_90a:
//
//     out[n, y, x, c] = b[c] + sum_{ky, kx} x[n, y + ky - 3, x + kx - 3, c] * w[ky, kx, 0, c]
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/depthwise_conv.py
// (`_dw_call` / `_dw_kernel`), which holds one zero-padded image in VMEM and
// accumulates 49 shifted multiply-adds.  Here no padded copy exists: a
// thread owns one channel of TW consecutive output pixels of a row, keeps
// that channel's 49 taps in registers, reads each input value of its 7 x
// (TW + 6) window once with a bounds check (SAME padding) and accumulates in
// fp32.  Consecutive threads take consecutive channels, so every load and
// store is coalesced over C.
//
// Layout: x / out [n, H, W, C] (NHWC, contiguous), w [7, 7, 1, C] (HWIO),
// b [C]; all of one type T (float or __nv_bfloat16).  Any H, W >= 1, any C.
// What bounds it: 98 operations per output against 2 * sizeof(T) bytes per
// output moved, so bytes (each input read once, each output written once);
// the window re-reads hit L1/L2.

#include "common.cuh"

namespace {

using namespace mmg;

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int TW = 4;  // output pixels per thread along W
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
          T* __restrict__ out, int h, int wd, int c, int tiles_w, long long total) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total; idx += stride) {
    const int ch = (int)(idx % c);
    long long rest = idx / c;
    const int tx = (int)(rest % tiles_w);
    rest /= tiles_w;
    const int py = (int)(rest % h);
    const long long img = rest / h;
    const int x0 = tx * TW;

    float taps[KS * KS];
#pragma unroll
    for (int k = 0; k < KS * KS; ++k) taps[k] = to_f<T>(w[k * c + ch]);
    float acc[TW];
#pragma unroll
    for (int t = 0; t < TW; ++t) acc[t] = 0.0f;

    const T* xb = x + img * h * (long long)wd * c + ch;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const int yy = py + ky - HALO;
      if (yy >= 0 && yy < h) {
        const T* row = xb + (long long)yy * wd * c;
#pragma unroll
        for (int kx = 0; kx < TW + KS - 1; ++kx) {
          const int xx = x0 + kx - HALO;
          const float v = (xx >= 0 && xx < wd) ? to_f<T>(row[(long long)xx * c]) : 0.0f;
#pragma unroll
          for (int t = 0; t < TW; ++t) {
            const int k = kx - t;
            if (k >= 0 && k < KS) acc[t] += v * taps[ky * KS + k];
          }
        }
      }
    }
    const float bias = to_f<T>(b[ch]);
    T* ob = out + ((img * h + py) * (long long)wd) * c + ch;
#pragma unroll
    for (int t = 0; t < TW; ++t)
      if (x0 + t < wd) ob[(long long)(x0 + t) * c] = from_f<T>(acc[t] + bias);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int n, int h,
                   int wd, int c, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + TW - 1) / TW;
  const long long total = (long long)n * h * tiles_w * c;
  const long long want = (total + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 32LL * sms ? want : 32LL * sms);
  dw_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), h, wd, c, tiles_w, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int mmg_depthwise_conv7x7(int dtype, const void* x, const void* w, const void* b, void* out,
                          int n, int h, int wd, int c, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, b, out, n, h, wd, c, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, out, n, h, wd, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
