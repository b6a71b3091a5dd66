// The ConvNeXt downsample in one kernel, for sm_90a: a LayerNorm over the
// input channels of every input pixel, then the 2x2/2 conv and its bias,
//
//     out[oy, ox, :] = bias + sum_{dy, dx} LN(x[2oy + dy, 2ox + dx, :]) . k[dy, dx]
//
// with LN(.) taken as 0 past the true H, W (the JAX tower normalises first
// and zero-pads after, bottom/right, so odd sizes come out exactly).
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/fused_downsample.py
// (`_fused_call` / `_kernel`), which needed the dx pairs merged into lanes
// by a reshape outside the kernel and row bands sized to VMEM.  Here a CTA
// owns P consecutive output pixels of the flattened n*Ho*Wo range and reads
// their 2x2 input pixels straight from device memory.
//
// Layout: x [n, H, W, Cin] (T); ns / nb [Cin] fp32; k [2, 2, Cin, Cout]
// (T, HWIO); bias [Cout] (T); out [n, ceil(H/2), ceil(W/2), Cout] (T).
//
// Design.  (a) One warp per input pixel: fp32 two-pass LN (eps 1e-6), the
// result rounded to T (the JAX kernel casts it to the weight dtype before the
// tap products), zero past H, W, into shared memory [P][4][Cin]; (b) thread
// item (group of PT pixels, co) accumulates the 4*Cin products in fp32 for
// its PT pixels, reading k straight from device memory (coalesced over co;
// the 2.4 MB of 384->768 bf16 weights stay in L2, too large for shared
// memory), plus the bias.  What bounds it: 8*Cin*Cout operations per output
// pixel against (4*Cin + Cout)*sizeof(T) bytes, so operations at these
// widths (fp32 FMA loops here; tensor cores are later work).

#include "common.cuh"

namespace {

using namespace mmg;

constexpr int THREADS = 256;
constexpr int PT = 8;  // output pixels per thread item

size_t smem_bytes(int p, int cin) { return (size_t)p * 4 * cin * sizeof(float); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
downsample_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                  const float* __restrict__ nb, const T* __restrict__ k,
                  const T* __restrict__ bias, T* __restrict__ out, int h, int w, int cin,
                  int cout, int ho, int wo, long long total, int p_tile, float eps) {
  extern __shared__ __align__(16) float xs[];  // [P][4][cin]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long pix0 = (long long)blockIdx.x * p_tile;

  // (a) LN of every input pixel of the tile, zero outside the image
  for (int r = warp; r < p_tile * 4; r += THREADS / 32) {
    const int p = r >> 2;
    const int tap = r & 3;  // dy * 2 + dx
    float* row = xs + (long long)r * cin;
    const long long pix = pix0 + p;
    bool valid = pix < total;
    long long src = 0;
    if (valid) {
      const long long img = pix / ((long long)ho * wo);
      const int rem = (int)(pix - img * ho * wo);
      const int oy = rem / wo;
      const int ox = rem - oy * wo;
      const int yy = 2 * oy + (tap >> 1);
      const int xx = 2 * ox + (tap & 1);
      valid = yy < h && xx < w;
      src = ((img * h + yy) * w + xx) * cin;
    }
    if (!valid) {
      for (int ch = lane; ch < cin; ch += 32) row[ch] = 0.0f;
      continue;
    }
    for (int ch = lane; ch < cin; ch += 32) row[ch] = to_f<T>(x[src + ch]);
    __syncwarp();
    const float2 st = warp_row_stats(row, cin, eps);
    for (int ch = lane; ch < cin; ch += 32)
      row[ch] = round_to<T>((row[ch] - st.x) * st.y * ns[ch] + nb[ch]);
  }
  __syncthreads();

  // (b) the four tap products, PT pixels per item
  const int groups = p_tile / PT;
  for (int item = tid; item < groups * cout; item += THREADS) {
    const int g = item / cout;
    const int co = item - g * cout;
    float a[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) a[i] = 0.0f;
    for (int tap = 0; tap < 4; ++tap) {
      const T* kt = k + (long long)tap * cin * cout + co;
      const float* xt = xs + ((long long)g * PT * 4 + tap) * cin;
      for (int ci = 0; ci < cin; ++ci) {
        const float wv = to_f<T>(kt[(long long)ci * cout]);
#pragma unroll
        for (int i = 0; i < PT; ++i) a[i] += xt[(long long)i * 4 * cin + ci] * wv;
      }
    }
    const float b = to_f<T>(bias[co]);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const long long pix = pix0 + (long long)g * PT + i;
      if (pix < total) out[pix * cout + co] = from_f<T>(a[i] + b);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* ns, const float* nb, const void* k,
                   const void* bias, void* out, int n, int h, int w, int cin, int cout, float eps,
                   cudaStream_t stream) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const long long total = (long long)n * ho * wo;
  const int candidates[4] = {64, 32, 16, 8};
  const int p = pick_tile(candidates, 4, total, [&](int q) { return smem_bytes(q, cin); });
  if (p < 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, cin);
  cudaError_t err = cudaFuncSetAttribute(downsample_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((total + p - 1) / p);
  downsample_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), ns, nb, static_cast<const T*>(k), static_cast<const T*>(bias),
      static_cast<T*>(out), h, w, cin, cout, ho, wo, total, p, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int mmg_fused_downsample(int dtype, const void* x, const float* ns, const float* nb,
                         const void* k, const void* bias, void* out, int n, int h, int w,
                         int cin, int cout, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, ns, nb, k, bias, out, n, h, w, cin, cout, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, ns, nb, k, bias, out, n, h, w, cin, cout, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
