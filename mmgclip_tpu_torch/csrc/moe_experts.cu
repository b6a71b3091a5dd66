// The routed experts of a DeepSeek-V3 MoE layer as two grouped GEMMs over
// the rows sorted by expert (ops/moe_experts.py sorts them on the device and
// hands over the offsets; nothing is read back to the host, so a layer can
// be captured in a CUDA graph).  It replaces no TPU kernel: the JAX package
// has no MoE tower; the port added it with models/deepseek_v3.py.
//
//   mmg_moe_gate_up: h[r, :] = silu(x[tok[r]] . Wg[e]^T) * (x[tok[r]] . Wu[e]^T)
//                    for the rows r of expert e; the activation rows are
//                    gathered in the loads (no gathered copy of x), and the
//                    SwiGLU is the epilogue: each CTA's 128 B rows are 64 gate
//                    rows and the 64 up rows of the same outputs, laid out so
//                    that a thread holds the gate and up sums of one output.
//   mmg_moe_down:    out[dest[r], :] = w[r] * (h[r] . Wd[e]^T), rounded to
//                    bf16, written to the row's (token, slot) place, so that
//                    the caller sums each token's k rows in a fixed order.
//
// Bound: tensor-core operations (at the published widths a chunk gives each
// expert ~12,000 rows: 2 * rows * 2048 * 1408 * 3 operations against ~9 GB of
// operand and result bytes, far above the ~295 operations a byte the card
// needs).  Design: 128 x 128 x 64 tiles, 8 warps of 64 x 32, bf16 mma.sync
// m16n8k16 with float32 sums, operands by cp.async into three stages of
// XOR-swizzled shared memory (ldmatrix without bank conflicts), the N tiles
// of one M tile adjacent in the grid so that an A tile is read from HBM once
// and an expert's weights stay in L2 across its M tiles.  A fixed grid of
// ceil(R / 128) + E M tiles; a CTA finds its expert in ``tile_offsets``
// (cumulative tiles per expert) and past the last tile exits at once.
// K must be a multiple of 8 (16-byte rows); a ragged K tile is zero-filled.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TILE_BYTES = BM * BK * 2;  // one operand tile; BN == BM
constexpr int SMEM_BYTES = STAGES * 2 * TILE_BYTES;

// byte offset of 16-byte chunk ``chunk`` (0..7) of tile row ``row`` (128 bytes a row)
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// GATED: a = x [tokens, k] gathered through a_rows, b = [E, 2n, k] (gate rows
// then up rows), out = h [R, n].  Else: a = h [R, k], b = [E, n, k], out =
// [R, n] at row dest[r], scaled by row_weights[r].
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
grouped_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ a_rows,
                    const bf16* __restrict__ b, const int* __restrict__ offsets,
                    const int* __restrict__ tile_offsets, const float* __restrict__ row_weights,
                    const int* __restrict__ dest, bf16* __restrict__ out, int experts, int n,
                    int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.y;
  if (tile >= tile_offsets[experts]) return;
  int lo = 0, hi = experts;  // tile_offsets[lo] <= tile < tile_offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_offsets[mid] <= tile) lo = mid; else hi = mid;
  }
  const int e = lo;
  const int row0 = offsets[e] + (tile - tile_offsets[e]) * BM;
  const int row_end = offsets[e + 1];
  const int n0 = blockIdx.x * (GATED ? BN / 2 : BN);
  const size_t b_rows = GATED ? 2 * (size_t)n : (size_t)n;
  const bf16* b_expert = b + (size_t)e * b_rows * k;

  const int tid = threadIdx.x;
  // each thread copies 4 chunks of A and 4 of B a stage: rows tid / 8 + 32 i
  const bf16* a_src[4];
  const bf16* b_src[4];
  bool a_ok[4], b_ok[4];
  const int chunk = tid & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 32 * i;
    const int grow = row0 + r;
    a_ok[i] = grow < row_end;
    const int src = a_ok[i] ? (GATED ? a_rows[grow] : grow) : 0;
    a_src[i] = a + (size_t)src * k + chunk * 8;
    int brow, bcol;
    if (GATED) {
      bcol = n0 + (r & 63);
      brow = r < 64 ? bcol : n + bcol;
    } else {
      bcol = n0 + r;
      brow = bcol;
    }
    b_ok[i] = bcol < n;
    b_src[i] = b_expert + (size_t)(b_ok[i] ? brow : 0) * k + chunk * 8;
  }

  auto load_stage = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * 2 * TILE_BYTES;
    unsigned char* sb = sa + TILE_BYTES;
    const int kk = kt * BK;
    const int in_k = (kk + chunk * 8 < k) ? 16 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      mmg::cp_async16(sa + swizzle(r, chunk), a_src[i] + (in_k ? kk : 0), a_ok[i] ? in_k : 0);
      mmg::cp_async16(sb + swizzle(r, chunk), b_src[i] + (in_k ? kk : 0), b_ok[i] ? in_k : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const int ktiles = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    mmg::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    mmg::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    mmg::cp_async_commit();
    const unsigned char* sa = smem + (kt % STAGES) * 2 * TILE_BYTES;
    const unsigned char* sb = sa + TILE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        mmg::ldmatrix_x4(af[mi], sa + swizzle(wm * 64 + mi * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // GATED: pair 0 = gate rows 16 wn.., pair 1 = the up rows of the same outputs
        const int base = GATED ? p * 64 + wn * 16 : wn * 32 + p * 16;
        mmg::ldmatrix_x4(bfr[p], sb + swizzle(base + ((lane >> 4) << 3) + (lane & 7),
                                              ks * 2 + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mmg::mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                        bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  mmg::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int grow = row0 + wm * 64 + mi * 16 + g + half * 8;
      if (grow >= row_end) continue;
      if (GATED) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 16 + j * 8 + 2 * t;
          if (col >= n) continue;
          const float* gate = &acc[mi][j][half * 2];
          const float* up = &acc[mi][j + 2][half * 2];
          *reinterpret_cast<unsigned*>(out + (size_t)grow * n + col) =
              mmg::pack_bf16(silu(gate[0]) * up[0], silu(gate[1]) * up[1]);
        }
      } else {
        const float w = row_weights[grow];
        bf16* dst = out + (size_t)dest[grow] * n;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          if (col >= n) continue;
          const float* c = &acc[mi][ni][half * 2];
          *reinterpret_cast<unsigned*>(dst + col) = mmg::pack_bf16(c[0] * w, c[1] * w);
        }
      }
    }
  }
}

template <bool GATED>
cudaError_t launch(const bf16* a, const int* a_rows, const bf16* b, const int* offsets,
                   const int* tile_offsets, const float* row_weights, const int* dest, bf16* out,
                   int experts, int n, int k, int max_tiles, cudaStream_t stream) {
  if (max_tiles <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (max_tiles > 65535 || k <= 0 || k % 8 != 0 || n % 2 != 0) return cudaErrorInvalidValue;
  const int per_cta = GATED ? BN / 2 : BN;
  const dim3 grid((n + per_cta - 1) / per_cta, max_tiles);
  grouped_gemm_kernel<GATED><<<grid, THREADS, SMEM_BYTES, stream>>>(
      a, a_rows, b, offsets, tile_offsets, row_weights, dest, out, experts, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [tokens, d_model] bf16; tokens [R] int32 (the token of each sorted row);
// w_gate_up [experts, 2 width, d_model] bf16; offsets, tile_offsets [experts + 1]
// int32; h [R, width] bf16.
int mmg_moe_gate_up(const void* x, const void* tokens, const void* w_gate_up,
                    const void* offsets, const void* tile_offsets, void* h, int experts,
                    int d_model, int width, int max_tiles, void* stream) {
  return launch<true>(static_cast<const bf16*>(x), static_cast<const int*>(tokens),
                      static_cast<const bf16*>(w_gate_up), static_cast<const int*>(offsets),
                      static_cast<const int*>(tile_offsets), nullptr, nullptr,
                      static_cast<bf16*>(h), experts, width, d_model, max_tiles,
                      static_cast<cudaStream_t>(stream));
}

// h [R, width] bf16; w_down [experts, d_model, width] bf16; row_weights [R]
// float32; dest [R] int32 (each sorted row's (token, slot) place); out [R,
// d_model] bf16.
int mmg_moe_down(const void* h, const void* w_down, const void* row_weights, const void* dest,
                 const void* offsets, const void* tile_offsets, void* out, int experts,
                 int d_model, int width, int max_tiles, void* stream) {
  return launch<false>(static_cast<const bf16*>(h), nullptr, static_cast<const bf16*>(w_down),
                       static_cast<const int*>(offsets), static_cast<const int*>(tile_offsets),
                       static_cast<const float*>(row_weights), static_cast<const int*>(dest),
                       static_cast<bf16*>(out), experts, d_model, width, max_tiles,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
