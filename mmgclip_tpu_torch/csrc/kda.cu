// The scan of a Kimi Delta Attention (KDA) layer of the Kimi-Linear text
// tower (models/kimi_linear.py), for sm_90a: the short convolutions, the
// per-head L2 norms, the decay gate, beta and the gated delta-rule recurrence
// of one padded bank chunk, fused.
//
// Replaces no TPU kernel: the JAX package has no Kimi-Linear tower.  It takes
// the place of the plain path (ops/kda.py::plain_kda), which widens the
// layer's projections to float32 copies, runs the convolutions, norms and
// gates as separate passes and the chunked form of the scan as batched float32
// products with a [rows, heads, 64, 64, 128] decay tensor a chunk of tokens.
//
// Contract (ops/kda.py, "launch_kda"):
//   * q, k, v, f [b, s, H * DK] bf16: the layer's q, k, v projections before
//     their convolutions and the decay gate's pre-activation ((h W_fa) W_fb),
//     each read in place (last dimension contiguous, 16-byte aligned, batch
//     and position strides multiples of 8); beta [b, s, H] bf16 logits.
//     wq, wk, wv [H * DK, 4] bf16: the causal depthwise convolutions (tap 3
//     multiplies the current token); a_log [H] and dt_bias [H * DK] float32;
//     lengths [b] int32, each row's valid prefix (right padding).
//   * per channel: x = silu(w0 x[t-3] + w1 x[t-2] + w2 x[t-1] + w3 x[t]),
//     zeros before position 0; q and k scaled per head by
//     rsqrt(sum of squares + 1e-6); g = -exp(a_log[h]) softplus(f + dt_bias)
//     (softplus as torch's, linear past 20), alpha = exp(g); beta = sigmoid.
//   * the recurrence per (row, head), state S [DK, DK] float32 from 0:
//     S <- diag(alpha_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;
//     o_t = scale * S^T q_t, written bf16 to out [b, s, H * DK] (contiguous);
//     positions at or past a row's length are written 0 and never read.
//   * variants (the benchmark's planted faults; 0 in the tower): reset_every
//     > 0 zeroes S before every token at a multiple of it; head_decay gives
//     every channel of a head the mean of the head's g (a scalar gate a head,
//     Gated DeltaNet's); state_bf16 rounds S to bf16 after each update.
//
// What bounds it: per valid token and head, ~4 DK^2 float32 operations of
// the recurrence (~2.1 MFLOP a token at 32 heads of 128), against ~41 KB a
// token moved (q, k, v, f read, o written, bf16).  A bank chunk of 256 rows
// at the published widths holds ~51,000 valid tokens: ~0.63 ms of HBM
// traffic at the least.
//
// Design: one CTA of 256 threads a (row, head), walking the row's valid
// tokens in steps of CH = 32:
//   * copy: the step's raw q, k, v, f rows arrive by 16-byte cp.async in a
//     shared buffer, issued while the step before runs (the first at launch);
//   * stage: threads [0, DK) take channel tid of q and k, threads [DK, 2 DK)
//     channel tid - DK of v and f; each runs its channel's causal convolution
//     over the step's tokens from the three raw values it carries in
//     registers, and writes silu(conv) (v, q, k) and g as float32;
//   * norms: a warp a token computes the step's q and k norms and turns g into
//     alpha in place (the head's mean first with head_decay);
//   * recurrence: thread (rb = tid % 8, cg = tid / 8) holds S's 16 rows
//     32 m + 4 rb + (0..3) of its 4 columns 4 cg + (0..3), 64 float32 in
//     registers, so each float4 of alpha, k or q read from shared memory (8
//     lanes, 128 contiguous bytes, the rest broadcasts) feeds 16 products.  A
//     token is two unrolled passes: (1) S *= alpha, dot = S . k; (2) S += k c,
//     o = S . q, each dot finished by three shuffles across the 8 row blocks.
//     No barrier inside a step.  (A first version gave each thread half of one
//     column: one float4 read a 4 products, 28.6 ms a layer-chunk, bound by
//     shared-memory reads.)
// Deterministic: no atomics, a fixed order of sums.
// Measured (chip_smoke.py phase 5f, one H100 SXM at 700 W): 8.63 ms a layer
// of a 256 x 512 bank chunk (51,565 valid tokens) against the 0.63 ms bound,
// at ~75% of the CUDA cores' instruction issue; the chunked form on the
// tensor cores would take ~2x fewer operations.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int DK = 128;           // the head size
constexpr int CH = 32;            // tokens staged a step
constexpr int RB = 8;             // row blocks: the threads that share a column group
constexpr int CG = DK / 4;        // column groups of 4
constexpr int THREADS = RB * CG;  // 256
constexpr int MG = DK / (4 * RB); // float4 row groups a thread holds (4: 16 rows)
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 2 * DK, "staging: one thread a channel of (q, k) or (v, f)");
// shared memory: float32 k, q, alpha, v [CH][DK], then rk, rq, beta [CH], then
// the raw bf16 q, k, v, f [CH][DK] of the next step
constexpr size_t FLOATS = 4 * CH * DK + 3 * CH;
constexpr size_t SMEM = FLOATS * sizeof(float) + 4 * CH * DK * sizeof(bf16);

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
__device__ __forceinline__ float softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float at(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

// the causal convolution of one channel: taps w, the three previous raw values in h
__device__ __forceinline__ float conv4(const float (&w)[4], float (&h)[3], float x) {
  const float y = w[0] * h[0] + w[1] * h[1] + w[2] * h[2] + w[3] * x;
  h[0] = h[1], h[1] = h[2], h[2] = x;
  return y;
}

struct Inputs {
  const bf16* x[4];  // q, k, v, f of this (row, head), at channel 0
  long long ss[4];   // their position strides
};

// cp.async the raw q, k, v, f of tokens [c0, c0 + n) into shared memory
__device__ __forceinline__ void prefetch(const Inputs& in, bf16* raw, int c0, int n) {
  constexpr int SEGS = DK / 8;  // 16-byte pieces a token and array
  for (int p = threadIdx.x; p < 4 * CH * SEGS; p += THREADS) {
    const int arr = p / (CH * SEGS), rem = p - arr * CH * SEGS;
    const int t = rem / SEGS, seg = rem - t * SEGS;
    if (t < n)
      mmg::cp_async16(raw + (arr * CH + t) * DK + seg * 8,
                      in.x[arr] + (c0 + t) * in.ss[arr] + seg * 8, 16);
  }
  mmg::cp_async_commit();
}

template <bool BF16_STATE>
__global__ void __launch_bounds__(THREADS, 2)
kda_kernel(Inputs in0, long long q_sb, long long k_sb, long long v_sb, long long f_sb,
           const bf16* __restrict__ beta, long long b_sb, long long b_ss,
           const bf16* __restrict__ wq, const bf16* __restrict__ wk,
           const bf16* __restrict__ wv, const float* __restrict__ a_log,
           const float* __restrict__ dt_bias, const int* __restrict__ lengths,
           bf16* __restrict__ out, int heads, int s, int reset_every, int head_decay,
           float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sq = sk + CH * DK;
  float* sa = sq + CH * DK;
  float* sv = sa + CH * DK;
  float* srk = sv + CH * DK;
  float* srq = srk + CH;
  float* sbeta = srq + CH;
  bf16* raw = reinterpret_cast<bf16*>(smem + FLOATS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, row = blockIdx.y;
  const int len = min(max(lengths[row], 0), s);
  const long long HD = (long long)heads * DK;
  bf16* orow = out + (long long)row * s * HD + (long long)h * DK;
  Inputs in = in0;
  const long long sbs[4] = {q_sb, k_sb, v_sb, f_sb};
#pragma unroll
  for (int a = 0; a < 4; ++a) in.x[a] += row * sbs[a] + (long long)h * DK;
  if (len > 0) prefetch(in, raw, 0, min(CH, len));

  // staging role: channel ch of (q, k) or of (v, f)
  const int ch = tid % DK;
  const bool qk = tid < DK;
  const long long c = (long long)h * DK + ch;
  const bf16* raw_a = raw + (qk ? 0 : 2) * CH * DK + ch;
  const bf16* raw_b = raw + (qk ? 1 : 3) * CH * DK + ch;
  float wa[4], wb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wa[i] = ld((qk ? wq : wv) + c * 4 + i);
    if (qk) wb[i] = ld(wk + c * 4 + i);
  }
  float ha[3] = {0.0f, 0.0f, 0.0f}, hb[3] = {0.0f, 0.0f, 0.0f};
  const float neg_a = -expf(a_log[h]);
  const float dtb = qk ? 0.0f : dt_bias[c];

  // recurrence role: rows 32 m + 4 rb + r (m < MG, r < 4) of columns 4 cg + (0..3)
  const int rb = tid & (RB - 1), cg = tid / RB;
  float S[MG][4][4];
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[m][r][j] = 0.0f;

  for (int c0 = 0; c0 < len; c0 += CH) {
    const int n = min(CH, len - c0);
    mmg::cp_async_wait<0>();
    __syncthreads();  // the step's raw inputs landed; every thread is done with the last step
    for (int t = 0; t < n; ++t) {
      const float ya = silu(conv4(wa, ha, __bfloat162float(raw_a[t * DK])));
      const float xb = __bfloat162float(raw_b[t * DK]);
      if (qk) {
        sq[t * DK + ch] = ya;
        sk[t * DK + ch] = silu(conv4(wb, hb, xb));
      } else {
        sv[t * DK + ch] = ya;
        sa[t * DK + ch] = neg_a * softplus(xb + dtb);  // g, turned into alpha below
      }
    }
    if (tid < n)
      sbeta[tid] = 1.0f / (1.0f + expf(-ld(beta + row * b_sb + (long long)(c0 + tid) * b_ss + h)));
    __syncthreads();  // raw is free: the next step's copy runs under this one's work
    if (c0 + CH < len) prefetch(in, raw, c0 + CH, min(CH, len - c0 - CH));

    // a warp a token: the norms of q and k, and alpha from g
    for (int t = warp; t < n; t += WARPS) {
      const float4 a = *reinterpret_cast<const float4*>(sq + t * DK + lane * 4);
      const float4 b = *reinterpret_cast<const float4*>(sk + t * DK + lane * 4);
      float4 g = *reinterpret_cast<const float4*>(sa + t * DK + lane * 4);
      const float qq = mmg::warp_sum(a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w);
      const float kk = mmg::warp_sum(b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w);
      if (head_decay) {
        const float mean = mmg::warp_sum((g.x + g.y) + (g.z + g.w)) / DK;
        g = make_float4(mean, mean, mean, mean);
      }
      if (lane == 0) {
        srq[t] = rsqrtf(qq + 1e-6f) * scale;
        srk[t] = rsqrtf(kk + 1e-6f);
      }
      *reinterpret_cast<float4*>(sa + t * DK + lane * 4) =
          make_float4(expf(g.x), expf(g.y), expf(g.z), expf(g.w));
    }
    __syncthreads();

    // the recurrence over the step's tokens
    for (int t = 0; t < n; ++t) {
      if (reset_every > 0 && (c0 + t) % reset_every == 0) {
#pragma unroll
        for (int m = 0; m < MG; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) S[m][r][j] = 0.0f;
      }
      float kr[MG][4], dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        const int i = 32 * m + 4 * rb;
        const float4 a = *reinterpret_cast<const float4*>(sa + t * DK + i);
        const float4 b = *reinterpret_cast<const float4*>(sk + t * DK + i);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kr[m][r] = at(b, r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            S[m][r][j] *= at(a, r);
            dot[j] = fmaf(S[m][r][j], kr[m][r], dot[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dot[j] += __shfl_xor_sync(FULL, dot[j], 1);
        dot[j] += __shfl_xor_sync(FULL, dot[j], 2);
        dot[j] += __shfl_xor_sync(FULL, dot[j], 4);
      }
      // S += beta k_hat (v - S^T k_hat)^T with k_hat = rk k: column j takes k cj
      const float rk = srk[t], bt = sbeta[t] * rk;
      const float4 v = *reinterpret_cast<const float4*>(sv + t * DK + 4 * cg);
      float cj[4], o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 4; ++j) cj[j] = bt * (at(v, j) - rk * dot[j]);
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        const float4 e = *reinterpret_cast<const float4*>(sq + t * DK + 32 * m + 4 * rb);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            S[m][r][j] = fmaf(kr[m][r], cj[j], S[m][r][j]);
            if constexpr (BF16_STATE) S[m][r][j] = mmg::round_to<bf16>(S[m][r][j]);
            o[j] = fmaf(S[m][r][j], at(e, r), o[j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] += __shfl_xor_sync(FULL, o[j], 1);
        o[j] += __shfl_xor_sync(FULL, o[j], 2);
        o[j] += __shfl_xor_sync(FULL, o[j], 4);
      }
      if (rb == 0) {
        const float sc = srq[t];
        uint2 packed;
        packed.x = mmg::pack_bf16(o[0] * sc, o[1] * sc);
        packed.y = mmg::pack_bf16(o[2] * sc, o[3] * sc);
        *reinterpret_cast<uint2*>(orow + (long long)(c0 + t) * HD + 4 * cg) = packed;
      }
    }
  }

  // positions at or past the row's length
  for (long long e = tid; e < (long long)(s - len) * DK; e += THREADS)
    orow[(len + e / DK) * HD + e % DK] = __float2bfloat16(0.0f);
}

template <bool BF16_STATE>
cudaError_t launch(const Inputs& in, long long q_sb, long long k_sb, long long v_sb,
                   long long f_sb, const void* beta, long long b_sb, long long b_ss,
                   const void* wq, const void* wk, const void* wv, const float* a_log,
                   const float* dt_bias, const int* lengths, void* out, int b, int heads, int s,
                   int reset_every, int head_decay, float scale, cudaStream_t stream) {
  auto kernel = kda_kernel<BF16_STATE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)heads, (unsigned)b);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      in, q_sb, k_sb, v_sb, f_sb, static_cast<const bf16*>(beta), b_sb, b_ss,
      static_cast<const bf16*>(wq), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      a_log, dt_bias, lengths, static_cast<bf16*>(out), heads, s, reset_every, head_decay, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Strides in elements: q, k, v and f each 16-byte aligned with batch and
// position strides that are multiples of 8.  head_dim: 128.  Returns a
// cudaError_t (0 = success).
int mmg_kda(const void* q, long long q_sb, long long q_ss, const void* k, long long k_sb,
            long long k_ss, const void* v, long long v_sb, long long v_ss, const void* f,
            long long f_sb, long long f_ss, const void* beta, long long b_sb, long long b_ss,
            const void* wq, const void* wk, const void* wv, const float* a_log,
            const float* dt_bias, const int* lengths, void* out, int b, int heads, int s,
            int head_dim, int reset_every, int head_decay, int state_bf16, float scale,
            void* stream) {
  if (b <= 0 || b > 65535 || heads <= 0 || heads > 65535 || s <= 0 || reset_every < 0 ||
      head_dim != DK)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(f) ||
      (q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | f_sb | f_ss) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Inputs in;
  in.x[0] = static_cast<const bf16*>(q), in.x[1] = static_cast<const bf16*>(k);
  in.x[2] = static_cast<const bf16*>(v), in.x[3] = static_cast<const bf16*>(f);
  in.ss[0] = q_ss, in.ss[1] = k_ss, in.ss[2] = v_ss, in.ss[3] = f_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = state_bf16 ? launch<true> : launch<false>;
  return (int)go(in, q_sb, k_sb, v_sb, f_sb, beta, b_sb, b_ss, wq, wk, wv, a_log, dt_bias, lengths,
                 out, b, heads, s, reset_every, head_decay, scale, st);
}

}  // extern "C"
