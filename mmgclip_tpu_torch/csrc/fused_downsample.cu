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
// by a reshape outside the kernel and row bands sized to VMEM.
//
// Layout: x [n, H, W, Cin] (T); ns / nb [Cin] fp32; k [2, 2, Cin, Cout]
// (T, HWIO), read as the matrix W [4 Cin, Cout] whose row (dy * 2 + dx) *
// Cin + ci is k[dy, dx, ci]; bias [Cout] (T); out [n, ceil(H/2), ceil(W/2),
// Cout] (T).  Cin % 4 == 0, Cout % 4 == 0.
//
// What bounds it: 8*Cin*Cout operations per output pixel against
// (4*Cin + Cout)*sizeof(T) bytes: in bf16 128 and 256 operations a byte for
// ConvNeXt-Tiny's first two downsamples (bytes: the card does ~295 bf16
// operations per byte of HBM), 512 for the last (operations).
//
// Design: an LN-prologue GEMM on the tensor cores, out = A . W + bias with
// A [M, 4 Cin] the LN'd 2 x 2 patches (M output pixels).  A CTA owns BM =
// 16 * WM consecutive output pixels and all Cout columns, with WM x WN
// warps: warp (wm, wn) owns rows [16 wm, 16 wm + 16) and columns
// [wn NW, wn NW + NW), NW <= 96, its sums 16 x NW fp32 in registers.
//   (i)   one warp per input pixel (several at once, channel pairs a lane):
//         fp32 two-pass LN (eps 1e-6), rounded to T (the JAX kernel casts it
//         to the weight dtype before the tap products), zero past H, W and
//         past the last output pixel, into the A tile [BM, 4 Cin] at column
//         (dy * 2 + dx) * Cin + ci;
//   (ii)  W streams through shared memory as K slices [KS, Cout] by 16-byte
//         cp.async in stages (zero-filled past Cout), one barrier a slice,
//         read once per CTA instead of once per output pixel; the A tile
//         stays put;
//   (iii) the fp32 O fragments go through an O tile in shared memory; out =
//         O + bias is stored from it by 4-vectors.
// bf16 runs mma.sync m16n8k16 (fp32 sums) with A fragments by ldmatrix and
// the K-major weight fragments by ldmatrix.trans; fp32 runs the same tiles
// on m16n8k8 TF32 in the three-pass split, each k step's products summed
// apart and added to the running sum in fp32 (within 1e-4 with TF32 off).
// BM is the largest whose shared memory fits that still gives every SM a row
// tile.  No atomics: two launches give the same bits.

#include "common.cuh"

#include <algorithm>

namespace {

using namespace mmg;

constexpr int THREADS = 512;     // threads of a CTA at most (16 warps)
constexpr int OUT_BLOCKS = 12;   // 8-column blocks of the output a warp holds (96 columns)
constexpr int MAX_STAGES = 8;    // weight slices in flight at most

// Per type: the mma's K step; the padding of the A rows (16 bytes in bf16,
// 4 words in fp32); the bytes a weight stage holds at least
template <typename T> __host__ __device__ constexpr int kstep() { return sizeof(T) == 2 ? 16 : 8; }
template <typename T> __host__ __device__ constexpr int act_pad() { return sizeof(T) == 2 ? 8 : 4; }
template <typename T> constexpr int stage_bytes() { return sizeof(T) == 2 ? 65536 : 32768; }

struct Plan {
  int k;            // 4 * Cin: the products' depth
  int np;           // Cout rounded up to 16
  int wn, wm, nw;   // warps across the columns / the rows; columns a warp holds (<= 96)
  int ks, slices;   // K rows of a weight slice; slices
  int stages;       // slices in flight (2..MAX_STAGES)
  int a_stride, w_stride, stage_elems;  // in elements
  size_t smem;      // bytes
};

// The tile plan, or wm = 0 when none fits in ``max_smem`` bytes.
template <typename T>
Plan plan_for(int cin, int cout, long long rows, int max_smem, int sms) {
  Plan p{};
  p.k = 4 * cin;
  p.np = (cout + 15) / 16 * 16;
  p.wn = (p.np + 95) / 96;
  p.nw = ((p.np + p.wn - 1) / p.wn + 15) / 16 * 16;
  p.a_stride = p.k + act_pad<T>();
  p.w_stride = p.np + 8;
  const int cap = std::max(16 * p.w_stride, stage_bytes<T>() / (int)sizeof(T));
  p.ks = std::min(p.k, cap / p.w_stride / 16 * 16);
  p.stage_elems = p.ks * p.w_stride;
  p.slices = (p.k + p.ks - 1) / p.ks;
  const int max_warps = THREADS / 32;
  if (p.wn > max_warps) return p;
  for (int wm = max_warps / p.wn; wm >= 1; wm /= 2) {
    const long long bm = 16LL * wm;
    if (wm > 1 && (rows + bm - 1) / bm < sms) continue;  // a row tile for every SM first
    for (int stages = std::min(MAX_STAGES, std::max(2, p.slices)); stages >= 2; --stages) {
      // the stages and the A tile; the fp32 O tile [bm, Cout] reuses them
      const size_t bytes = std::max(((size_t)bm * p.a_stride + (size_t)stages * p.stage_elems) * sizeof(T),
                                    (size_t)bm * (cout + 4) * sizeof(float));
      if (bytes <= (size_t)max_smem) {
        p.wm = wm;
        p.stages = stages;
        p.smem = bytes;
        return p;
      }
    }
  }
  return p;
}

// (i) LN of ROWS input pixels at once (rows r, r + step, ...; row r of the
// CTA is tap r % 4 of output pixel r / 4), a lane holding the channel pairs
// 2 lane + 64 i, i < PAIRS (Cin <= 64 * PAIRS), rounded to T into the A
// tile; zero past H, W and past the last output pixel.
template <typename T, int ROWS, int PAIRS>
__device__ __forceinline__ void ln_taps(T* As, int a_stride, int r, int step, int rows,
                                        long long pix0, long long total, const T* __restrict__ x,
                                        const float* __restrict__ ns, const float* __restrict__ nb,
                                        int h, int w, int ho, int wo, int cin, float eps) {
  const int lane = threadIdx.x & 31;
  float2 v[ROWS][PAIRS];
  bool live[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int rr = r + q * step;
    const long long pix = pix0 + (rr >> 2);
    bool ok = rr < rows && pix < total;
    const T* src = x;
    if (ok) {
      const long long img = pix / ((long long)ho * wo);
      const int rem = (int)(pix - img * ho * wo);
      const int oy = rem / wo, ox = rem - (rem / wo) * wo;
      const int yy = 2 * oy + ((rr >> 1) & 1), xx = 2 * ox + (rr & 1);
      ok = yy < h && xx < w;
      src = x + ((img * h + yy) * w + xx) * cin;
    }
    live[q] = ok;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int ch = 2 * lane + 64 * i;  // Cin % 4 == 0: a pair lies wholly inside Cin or past it
      v[q][i] = ok && ch < cin ? load_pair<T>(src + ch) : make_float2(0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int rr = r + q * step;
    if (rr >= rows) break;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) sum += v[q][i].x + v[q][i].y;
    const float mean = warp_sum(sum) / (float)cin;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const float dx = v[q][i].x - mean, dy = v[q][i].y - mean;
      if (2 * lane + 64 * i < cin) sq += dx * dx + dy * dy;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)cin + eps);
    T* arow = As + (size_t)(rr >> 2) * a_stride + (rr & 3) * cin;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int ch = 2 * lane + 64 * i;
      if (ch < cin) {
        const float2 sc = *reinterpret_cast<const float2*>(ns + ch);
        const float2 sh = *reinterpret_cast<const float2*>(nb + ch);
        const float a = live[q] ? (v[q][i].x - mean) * rstd * sc.x + sh.x : 0.0f;
        const float b = live[q] ? (v[q][i].y - mean) * rstd * sc.y + sh.y : 0.0f;
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<unsigned*>(arow + ch) = pack_bf16(a, b);
        } else {
          *reinterpret_cast<float2*>(arow + ch) = make_float2(a, b);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
downsample_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                  const float* __restrict__ nb, const T* __restrict__ k,
                  const T* __restrict__ bias, T* __restrict__ out, int h, int w, int cin,
                  int cout, int ho, int wo, long long total, float eps, Plan p, int vec) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int KSTEP = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);            // [stages][stage_elems]
  const int bm = 16 * p.wm;
  T* As = stages + (size_t)p.stages * p.stage_elems;      // [bm][a_stride]

  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / p.wn, wn = warp - wm * p.wn;
  const int r0 = 16 * wm;
  const long long pix0 = (long long)blockIdx.x * bm;
  const int ocol0 = wn * p.nw, oblocks = max(0, min(p.nw, p.np - ocol0)) / 8;
  // ldmatrix lanes: A rows and columns; .trans rows (k) and columns (n)
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;

  auto stage_of = [&](int s) { return stages + (size_t)(s % p.stages) * p.stage_elems; };
  // slice s: rows [s KS, s KS + KS) of W, Np columns (zero past Cout)
  auto load = [&](int s) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
    T* buf = stage_of(s);
    const int k0 = s * p.ks, rows = min(p.ks, p.k - k0), per_row = p.np / E;
    for (int i = threadIdx.x; i < rows * per_row; i += nthreads) {
      const int r = i / per_row, e = (i - r * per_row) * E;
      T* dst = buf + r * p.w_stride + e;
      const T* src = k + (long long)(k0 + r) * cout + e;
      if (vec) {  // Cout % E == 0: a copy lies wholly inside Cout or past it
        cp_async16(dst, e < cout ? src : k, e < cout ? 16 : 0);
      } else {
        for (int q = 0; q < E; ++q) dst[q] = e + q < cout ? src[q] : from_f<T>(0.0f);
      }
    }
  };

  for (int s = 0; s < p.stages - 1; ++s) {  // the first slices' copies run under the LN
    if (s < p.slices) load(s);
    cp_async_commit();
  }

  // (i) LN of the CTA's 4 * bm input pixels into the A tile
  const int rows = 4 * bm;
  if (cin <= 64 * 3) {
    for (int r = warp; r < rows; r += 4 * nwarps)
      ln_taps<T, 4, 3>(As, p.a_stride, r, nwarps, rows, pix0, total, x, ns, nb, h, w, ho, wo, cin, eps);
  } else if (cin <= 64 * 6) {
    for (int r = warp; r < rows; r += 2 * nwarps)
      ln_taps<T, 2, 6>(As, p.a_stride, r, nwarps, rows, pix0, total, x, ns, nb, h, w, ho, wo, cin, eps);
  } else if (cin <= 64 * 12) {
    for (int r = warp; r < rows; r += nwarps)
      ln_taps<T, 1, 12>(As, p.a_stride, r, nwarps, rows, pix0, total, x, ns, nb, h, w, ho, wo, cin, eps);
  } else {
    for (int r = warp; r < rows; r += nwarps)
      ln_taps<T, 1, 24>(As, p.a_stride, r, nwarps, rows, pix0, total, x, ns, nb, h, w, ho, wo, cin, eps);
  }

  float acc[OUT_BLOCKS][4];
#pragma unroll
  for (int i = 0; i < OUT_BLOCKS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  // (ii) out += A[rows, k0 : k0 + krows] . W slice, one slice per step
  for (int s = 0; s < p.slices; ++s) {
    switch (p.stages) {  // this thread's copies of the slice have landed
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      case 4: cp_async_wait<2>(); break;
      case 5: cp_async_wait<3>(); break;
      case 6: cp_async_wait<4>(); break;
      case 7: cp_async_wait<5>(); break;
      default: cp_async_wait<6>(); break;
    }
    __syncthreads();  // slice landed for all; the A tile written; the oldest stage is free
    if (s + p.stages - 1 < p.slices) load(s + p.stages - 1);
    cp_async_commit();
    const T* buf = stage_of(s);
    const int k0 = s * p.ks, krows = min(p.ks, p.k - k0);
    for (int kk = 0; kk < krows; kk += KSTEP) {
      if constexpr (BF16) {
        unsigned a[4];
        ldmatrix_x4(a, As + (size_t)(r0 + arow) * p.a_stride + k0 + kk + acol);
#pragma unroll
        for (int blk = 0; blk < OUT_BLOCKS; blk += 2) {
          if (blk < oblocks) {
            unsigned b[4];
            ldmatrix_x4_trans(b, buf + (kk + vkey) * p.w_stride + ocol0 + blk * 8 + vcol);
            mma_bf16(acc[blk], a, b[0], b[1]);
            mma_bf16(acc[blk + 1], a, b[2], b[3]);
          }
        }
      } else {
        const float* ar = As + (size_t)(r0 + g) * p.a_stride + k0 + kk + t;
        unsigned ahi[4], alo[4];
        split(ar[0], ahi[0], alo[0]);
        split(ar[8 * p.a_stride], ahi[1], alo[1]);
        split(ar[4], ahi[2], alo[2]);
        split(ar[8 * p.a_stride + 4], ahi[3], alo[3]);
#pragma unroll
        for (int blk = 0; blk < OUT_BLOCKS; ++blk) {
          if (blk < oblocks) {
            const float* br = buf + (kk + t) * p.w_stride + ocol0 + blk * 8 + g;
            unsigned bh0, bl0, bh1, bl1;
            split(br[0], bh0, bl0);
            split(br[4 * p.w_stride], bh1, bl1);
            // the step's products in a fresh accumulator, added to the sum
            // rounding to nearest: the tensor cores align and truncate each
            // product to their accumulator, which over K = 4 Cin terms
            // biases the sum (phase 9 of chip_smoke.py holds the features
            // of this path to the plain downsample's within 1e-5)
            float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_3xtf32(step, ahi, alo, bh0, bh1, bl0, bl1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[blk][e] += step[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // (iii) O tile [bm, Cout + 4] fp32 over the spent stages and the A tile,
  // then out = O + bias by 4-vectors
  float* part = reinterpret_cast<float*>(smem_raw);
  const int ostride = cout + 4;
  __syncthreads();
#pragma unroll
  for (int blk = 0; blk < OUT_BLOCKS; ++blk) {
    const int n = ocol0 + blk * 8 + 2 * t;
    if (blk < oblocks && n < cout) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(part + (size_t)(r0 + g + 8 * half) * ostride + n) =
            make_float2(acc[blk][2 * half], acc[blk][2 * half + 1]);
    }
  }
  __syncthreads();
  const int groups = bm * cout / 4;
  for (int i = threadIdx.x; i < groups; i += nthreads) {
    const int row = 4 * i / cout, col = 4 * i - row * cout;
    const long long pix = pix0 + row;
    if (pix >= total) continue;
    const float4 o = *reinterpret_cast<const float4*>(part + (size_t)row * ostride + col);
    const float4 b = load4(bias + col);
    store4(out + pix * cout + col, make_float4(o.x + b.x, o.y + b.y, o.z + b.z, o.w + b.w));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* ns, const float* nb, const void* k,
                   const void* bias, void* out, int n, int h, int w, int cin, int cout, float eps,
                   cudaStream_t stream) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const long long total = (long long)n * ho * wo;
  auto kernel = downsample_kernel<T>;
  int max_smem = 0, dev = 0, sms = 0;
  cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Plan p = plan_for<T>(cin, cout, total, max_smem, sms);
  if (p.wm == 0) return cudaErrorInvalidValue;
  const long long blocks = (total + 16LL * p.wm - 1) / (16LL * p.wm);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 && (cout * sizeof(T)) % 16 == 0;
  kernel<<<(unsigned)blocks, 32 * p.wm * p.wn, p.smem, stream>>>(
      static_cast<const T*>(x), ns, nb, static_cast<const T*>(k), static_cast<const T*>(bias),
      static_cast<T*>(out), h, w, cin, cout, ho, wo, total, eps, p, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Cin % 4 == 0, Cout % 4 == 0, Cin and
// Cout <= 1536.  Returns a cudaError_t (0 = success).
int mmg_fused_downsample(int dtype, const void* x, const float* ns, const float* nb,
                         const void* k, const void* bias, void* out, int n, int h, int w,
                         int cin, int cout, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 4 || cout % 4 || cin > 1536 ||
      cout > 1536)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, ns, nb, k, bias, out, n, h, w, cin, cout, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, ns, nb, k, bias, out, n, h, w, cin, cout, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
