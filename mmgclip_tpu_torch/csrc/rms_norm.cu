// RMSNorm over bf16 rows in one pass, for sm_90a: the DeepSeek-V3 family's
// norms (models/deepseek_v3.py: input_layernorm, post_attention_layernorm,
// kv_a_layernorm, the final norm) and, with a gate, the Kimi-Linear KDA
// layer's output gate y = RMSNorm_d(o) * sigmoid(r) (models/kimi_linear.py).
//
// Replaces no TPU kernel: the JAX package has no RMSNorm tower.  It takes the
// place of the plain path (ops/rms_norm.py::plain_rms_norm), which makes six
// passes a call over float32 copies of the rows (the widening copy, the
// square, the mean, the scale, the weight, the cast back; the gate adds its
// own copy, sigmoid and product).
//
// Contract (ops/rms_norm.py, "launch_rms_norm"):
//   * x: rows of `width` bf16 (a multiple of 8, at most 2,304), the last
//     dimension contiguous, `x_rs` elements from one row to the next (a
//     multiple of 8, so the kv_a_layernorm input can be read as the split
//     view of the kv_a projection, row stride 576, with no copy), 16-byte
//     aligned;
//   * w: the weight, `width` bf16, contiguous and 16-byte aligned;
//   * r: the gate, null or bf16 rows laid out as x's (`r_rs`);
//   * out: contiguous rows of `width`, bf16 or (out_f32) float32.
//   * per row: s = sum x^2 in float32, y = x * rsqrt(s / width + eps) *
//     float(w); with a gate y *= 1 / (1 + expf(-r)); y rounded once to the
//     output type.  No fast math (no __expf, no __fdividef).  Every row is
//     computed, padding rows included.
//   * deterministic: each row's sum runs in a fixed order (a lane's elements
//     in order, then a fixed butterfly of shuffles), no atomics, and a row's
//     result depends on that row alone.
//
// What bounds it: bytes.  A row is read once and written once (the gate read
// once more); about 1 operation a byte, far below the ~295 operations a byte
// at which the tensor cores, not HBM, would bound it.  At the bank cells'
// shapes: [131,072, 2,304] bf16 1.21 GB (0.36 ms at 3.35 TB/s), [131,072,
// 2,048] 1.07 GB, the gate at [4,194,304, 128] 3.22 GB (0.96 ms).
//
// Design, for a pass bound by bytes:
//   * 16-byte vector loads and stores, neighbouring lanes on neighbouring
//     addresses (a warp reads 512 contiguous bytes of a row at a time);
//   * a group of G lanes a row (G = 32 for rows of 256 and more, else the
//     least power of two that covers the row's vectors: 16 lanes a row at
//     the gate's 128), each lane holding NV vectors of the row in registers
//     (the width class, a template: 9 at 2,304, 8 at 2,048, 2 at 512, 1 at
//     128; a width between classes takes the next one up), so the row is
//     read from HBM once and every load of a lane is in flight before the
//     sum needs any of it; the group sums by shuffles;
//   * the weight through the read-only path (a row of it is shared by every
//     row, so it stays in L1 / L2);
//   * as many CTAs of 256 threads as fit on the SMs at once, each warp
//     striding over its rows, so every SM keeps its loads in flight.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WIDTH = 2304;  // 32 lanes x 9 vectors x 8: the widest class
constexpr unsigned FULL = 0xffffffffu;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&y)[8]) {
  uint4 raw;
  raw.x = mmg::pack_bf16(y[0], y[1]);
  raw.y = mmg::pack_bf16(y[2], y[3]);
  raw.z = mmg::pack_bf16(y[4], y[5]);
  raw.w = mmg::pack_bf16(y[6], y[7]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

// NV: 16-byte vectors a lane holds (the width class); GATE: multiply by
// sigmoid(r); Out: bf16 or float.  group: lanes a row (a power of two <= 32).
template <int NV, bool GATE, typename Out>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const bf16* __restrict__ x, long long x_rs, const bf16* __restrict__ w,
                const bf16* __restrict__ r, long long r_rs, Out* __restrict__ out,
                long long rows, int width, int group, float eps) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (group - 1);
  const int vecs = width >> 3;
  const int per_warp = 32 / group;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * WARPS * per_warp;
  // every lane of a warp takes the same trips, so the shuffles see all 32
  for (long long base = warp * per_warp; base < rows; base += step) {
    const long long row = base + lane / group;
    const bool live = row < rows;
    uint4 xv[NV];
    uint4 rv[GATE ? NV : 1];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = sub + k * group;
      xv[k] = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (GATE) rv[k] = make_uint4(0u, 0u, 0u, 0u);
      if (live && j < vecs) {
        xv[k] = __ldg(reinterpret_cast<const uint4*>(x + row * x_rs) + j);
        if constexpr (GATE) rv[k] = __ldg(reinterpret_cast<const uint4*>(r + row * r_rs) + j);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float v[8];
      unpack8(xv[k], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(v[i], v[i], s);
    }
    for (int off = group >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    const float inv = rsqrtf(s / (float)width + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = sub + k * group;
      if (!live || j >= vecs) continue;
      float v[8], wf[8], y[8];
      unpack8(xv[k], v);
      unpack8(__ldg(reinterpret_cast<const uint4*>(w) + j), wf);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = v[i] * inv * wf[i];
      if constexpr (GATE) {
        float g[8];
        unpack8(rv[k], g);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = y[i] * (1.0f / (1.0f + expf(-g[i])));
      }
      store8(out + row * width + 8 * j, y);
    }
  }
}

struct Args {
  const bf16* x;
  long long x_rs;
  const bf16* w;
  const bf16* r;
  long long r_rs;
  void* out;
  long long rows;
  int width;
  float eps;
};

template <int NV, bool GATE, typename Out>
cudaError_t launch(const Args& a, int group, cudaStream_t st) {
  auto kernel = rms_norm_kernel<NV, GATE, Out>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long rows_per_cta = (long long)WARPS * (32 / group);
  const long long needed = (a.rows + rows_per_cta - 1) / rows_per_cta;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(needed < resident ? needed : resident);
  kernel<<<grid, THREADS, 0, st>>>(a.x, a.x_rs, a.w, a.r, a.r_rs, static_cast<Out*>(a.out),
                                   a.rows, a.width, group, a.eps);
  return cudaGetLastError();
}

template <int NV>
cudaError_t dispatch(const Args& a, int group, bool out_f32, cudaStream_t st) {
  if (a.r != nullptr)
    return out_f32 ? launch<NV, true, float>(a, group, st) : launch<NV, true, bf16>(a, group, st);
  return out_f32 ? launch<NV, false, float>(a, group, st) : launch<NV, false, bf16>(a, group, st);
}

}  // namespace

extern "C" {

// Strides in elements.  width: a multiple of 8, 8..2,304; x_rs and r_rs
// multiples of 8 and at least width; x, w, r and out 16-byte aligned; r may
// be null (no gate).  Returns a cudaError_t (0 = success).
int mmg_rms_norm(const void* x, long long x_rs, const void* w, const void* r, long long r_rs,
                 void* out, int out_f32, long long rows, int width, float eps, void* stream) {
  if (rows < 0 || width < 8 || width > MAX_WIDTH || width % 8 != 0 || x_rs < width ||
      x_rs % 8 != 0 || (r != nullptr && (r_rs < width || r_rs % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) || (r != nullptr && !aligned16(r)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int vecs = width / 8;
  int group = 32, per_lane = (vecs + 31) / 32;
  if (vecs < 32) {
    group = 1;
    while (group < vecs) group <<= 1;
    per_lane = 1;
  }
  const Args a{static_cast<const bf16*>(x), x_rs, static_cast<const bf16*>(w),
               static_cast<const bf16*>(r), r_rs, out, rows, width, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0;
  // the width classes: the least that holds the row's vectors
  if (per_lane <= 1) return (int)dispatch<1>(a, group, f32, st);
  if (per_lane <= 2) return (int)dispatch<2>(a, group, f32, st);
  if (per_lane <= 4) return (int)dispatch<4>(a, group, f32, st);
  if (per_lane <= 8) return (int)dispatch<8>(a, group, f32, st);
  return (int)dispatch<9>(a, group, f32, st);
}

}  // extern "C"
