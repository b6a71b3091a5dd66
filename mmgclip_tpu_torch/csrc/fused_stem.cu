// The ConvNeXt stem in one kernel, for sm_90a: a 4x4/4 patchify conv, its
// bias and a LayerNorm over the output channels,
//
//     out[p, :] = LN(patch(x, p) . k + bias)        (fp32 LN, eps 1e-6)
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/fused_stem.py
// (`_fused_call` / `_kernel`).  The TPU needed the 4x4 patches gathered into
// a [rows, 16*Cin] array by XLA before the kernel; here each CTA reads its
// patches straight from the NHWC input (zeros past the true H, W: the
// bottom/right `br_pad` of the JAX tower), so the input is read once and the
// conv output never leaves shared memory before the LN.
//
// Layout: x [n, H, W, Cin] (TX); k [16*Cin, Cout] (TW), rows in (dy, dx, ci)
// order, which is the HWIO kernel [4, 4, Cin, Cout] reshaped; bias [Cout]
// (TW); ns / nb [Cout] fp32; out [n, ceil(H/4), ceil(W/4), Cout] in TX.
// Patch values are rounded to TW (the JAX kernel casts the patches to the
// weight dtype), products accumulate in fp32.
//
// Design.  One CTA owns P consecutive output pixels of the flattened
// n*Ho*Wo range: (a) the 16*Cin x Cout weights (at most 18 KB in fp32) and
// the CTA's patches go to shared memory; (b) thread item (pixel, co) takes
// the 16*Cin-long dot product plus the bias; (c) one warp per pixel runs the
// two-pass LN and stores.  What bounds it: 2*16*Cin*Cout operations per
// output pixel against 16*Cin*sizeof(TX) bytes in and Cout*sizeof(TX) out;
// at Cin = 1, Cout = 96 that is ~3 kFLOP per ~450 bytes, so bytes.

#include "common.cuh"

namespace {

using namespace mmg;

constexpr int THREADS = 256;

size_t smem_bytes(int p, int k16, int cout) {
  return (size_t)(k16 * cout + p * k16 + p * cout) * sizeof(float);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const TX* __restrict__ x, const TW* __restrict__ k, const TW* __restrict__ bias,
            const float* __restrict__ ns, const float* __restrict__ nb, TX* __restrict__ out,
            int h, int w, int cin, int cout, int ho, int wo, long long total, int p_tile,
            float eps) {
  extern __shared__ __align__(16) float smem[];
  const int k16 = 16 * cin;
  float* ks = smem;                 // [k16][cout]
  float* ps = ks + k16 * cout;      // [P][k16] patches, rounded to TW
  float* ys = ps + p_tile * k16;    // [P][cout] conv output + bias

  const int tid = threadIdx.x;
  const long long pix0 = (long long)blockIdx.x * p_tile;
  for (int i = tid; i < k16 * cout; i += THREADS) ks[i] = to_f<TW>(k[i]);
  for (int i = tid; i < p_tile * k16; i += THREADS) {
    const int p = i / k16;
    const int e = i - p * k16;
    const long long pix = pix0 + p;
    float v = 0.0f;
    if (pix < total) {
      const long long img = pix / ((long long)ho * wo);
      const int rem = (int)(pix - img * ho * wo);
      const int oy = rem / wo;
      const int ox = rem - oy * wo;
      const int dy = e / (4 * cin);
      const int r2 = e - dy * 4 * cin;
      const int dx = r2 / cin;
      const int ci = r2 - dx * cin;
      const int yy = 4 * oy + dy;
      const int xx = 4 * ox + dx;
      if (yy < h && xx < w) v = round_to<TW>(to_f<TX>(x[((img * h + yy) * w + xx) * cin + ci]));
    }
    ps[i] = v;
  }
  __syncthreads();

  for (int i = tid; i < p_tile * cout; i += THREADS) {
    const int p = i / cout;
    const int co = i - p * cout;
    const float* pr = ps + p * k16;
    float s = 0.0f;
    for (int e = 0; e < k16; ++e) s += pr[e] * ks[e * cout + co];
    ys[i] = s + to_f<TW>(bias[co]);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int p = warp; p < p_tile; p += THREADS / 32) {
    const long long pix = pix0 + p;
    if (pix >= total) continue;
    const float* row = ys + p * cout;
    const float2 st = warp_row_stats(row, cout, eps);
    TX* o = out + pix * cout;
    for (int co = lane; co < cout; co += 32)
      o[co] = from_f<TX>((row[co] - st.x) * st.y * ns[co] + nb[co]);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* k, const void* bias, const float* ns,
                   const float* nb, void* out, int n, int h, int w, int cin, int cout,
                   float eps, cudaStream_t stream) {
  const int ho = (h + 3) / 4, wo = (w + 3) / 4;
  const long long total = (long long)n * ho * wo;
  const int k16 = 16 * cin;
  const int candidates[3] = {64, 32, 16};
  const int p = pick_tile(candidates, 3, total, [&](int q) { return smem_bytes(q, k16, cout); });
  if (p < 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, k16, cout);
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<TX, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((total + p - 1) / p);
  stem_kernel<TX, TW><<<blocks, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(k), static_cast<const TW*>(bias), ns, nb,
      static_cast<TX*>(out), h, w, cin, cout, ho, wo, total, p, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int mmg_fused_stem(int x_dtype, int w_dtype, const void* x, const void* k, const void* bias,
                   const float* ns, const float* nb, void* out, int n, int h, int w, int cin,
                   int cout, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, bf16>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<bf16, float>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<bf16, bf16>(x, k, bias, ns, nb, out, n, h, w, cin, cout, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
