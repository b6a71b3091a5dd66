// The routed experts of a DeepSeek-V3 MoE layer as two grouped GEMMs over
// the rows sorted by expert (ops/moe_experts.py sorts them on the device and
// hands over the offsets; nothing is read back to the host, so a layer can
// be captured in a CUDA graph).  It replaces no TPU kernel: the JAX package
// has no MoE tower; the port added it with models/deepseek_v3.py.
//
//   mmg_moe_gate_up: h[r, :] = silu(x[tok[r]] . Wg[e]^T) * (x[tok[r]] . Wu[e]^T)
//                    for the rows r of expert e; the activation rows are
//                    gathered in the loads (no gathered copy of x), and the
//                    SwiGLU is the epilogue on registers.
//   mmg_moe_down:    out[dest[r], :] = w[r] * (h[r] . Wd[e]^T), rounded to
//                    bf16, written to the row's (token, slot) place, so that
//                    the caller sums each token's k rows in a fixed order.
//
// Bound: tensor-core operations.  At the published widths a chunk gives each
// expert ~12,000 rows: 2 * rows * 2048 * 1408 * 3 operations against ~9 GB of
// operand and result bytes, far above the ~295 operations a byte the card
// needs; one layer's chunk is 13.76 ms at the bf16 peak.
//
// Design: Hopper's own path.  One grouped_gemm_kernel<GATED> for both GEMMs:
//   * output tiles of 128 rows x 256 B rows (gate|up: the 128 gate rows
//     [n0, n0 + 128) and the 128 up rows [I + n0, I + n0 + 128) of one expert,
//     so 128 outputs; down: 256 rows of Wd[e], 256 outputs), BK = 64, a ring
//     of stages of 48 KB (A 16 KB, B 32 KB) in 128-byte-swizzled shared
//     memory, a full and an empty mbarrier a stage; one CTA an SM.  Gate|up
//     keeps 4 stages, down 3: its staged output rows are twice as wide;
//   * warpgroup 2 produces (setmaxnreg.dec to 40), warpgroups 0 and 1 consume
//     (setmaxnreg.inc to 232): each runs wgmma.mma_async m64n256k16 on 64 of
//     the tile's rows, bf16 operands read through shared-memory descriptors,
//     float32 sums in registers.  With the gate|up layout above one thread
//     holds the gate and the up sum of the same outputs, so the SwiGLU is an
//     epilogue on registers;
//   * B (weights) and down's A (h, contiguous sorted rows) come in by TMA.
//     Gate|up's A rows are x[tokens[r]]: TMA has no row gather, so the
//     producer's 128 threads copy them with 16-byte cp.async into the same
//     swizzled layout and complete them on the stage's full barrier
//     (cp.async.mbarrier.arrive.noinc); no gathered copy of x is written;
//   * a persistent grid of one CTA an SM walks tiles blockIdx.x + i gridDim.x
//     up to tile_offsets[E] * n_tiles, read on the device.  The N tiles of
//     one M tile are consecutive (the gathered A tile is reused from L2), the
//     M tiles of one expert too (its weights stay in L2); a tile's expert is
//     found by binary search in tile_offsets.  The producer runs ahead across
//     tiles, so one tile's epilogue overlaps the next one's loads;
//   * epilogue: each warp rounds its 16 rows to bf16 into its slab of shared
//     memory, and lanes 0..15 send one row each to global memory by a bulk
//     copy (cp.async.bulk; down's to row dest[r]), which drains while the next
//     tile's products run.  Stored straight from registers, the writes of
//     all 132 CTAs' tiles at once held both warpgroups: 23% of down's time;
//   * ragged K and N: TMA's zero fill and cp.async's zero fill past K; the
//     epilogue sends no row past the expert's end and no column past N.
// Deterministic: one CTA owns each output tile and sums K in a fixed order
// (no split-K, no atomics), so a second launch gives the same bits.
// K and N must be multiples of 8 (16-byte rows: TMA's strides, bulk copies).
// Measured (one H100 SXM at 700 W, chip_smoke phase 5d's layer chunk:
// 131,072 tokens x top-6 of 64, 2048 -> 1408): gate|up 14.7-14.9 ms and down
// 7.0-7.2 ms, 21.6-22.1 ms a call against the 13.76 ms bound (62-64%), the SM
// clock held near 1,500 MHz by the power limit.  The mma.sync kernel this
// replaced (128 x 128 x 64 tiles, cp.async by every thread, two CTAs an SM)
// took 41.1 ms (34%).
#include "common.cuh"

#include <cuda.h>
#include <limits.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;           // rows of a tile (ops/moe_experts.py's TILE_ROWS)
constexpr int BN = 256;           // B rows of a tile
constexpr int BK = 64;            // 128 bytes of bf16: one swizzle row
constexpr int CONSUMERS = 2;      // warpgroups running wgmma
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;

// Shared memory: the ring (1024-aligned: the swizzle atoms), then the staged
// output rows (a pitch 16 bytes past the row, so that a warp's stores of 8
// rows fall in distinct banks), then a full and an empty barrier a stage.
// Down's 256 outputs a row leave room for 3 stages beside them; gate|up's
// 128 for 4.
template <bool GATED>
struct Layout {
  static constexpr int N_OUT = GATED ? BN / 2 : BN;  // outputs of a tile
  static constexpr int STAGES = GATED ? 4 : 3;
  static constexpr int PITCH = N_OUT * 2 + 16;
  static constexpr int STAGING = STAGES * STAGE_BYTES;
  static constexpr int BARRIERS = STAGING + BM * PITCH;
  static constexpr int BYTES = BARRIERS + 2 * STAGES * 8;
};
static_assert(Layout<true>::BYTES <= 232448 && Layout<false>::BYTES <= 232448,
              "a CTA has 227 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of the given parity to complete.  A wait of 2^35 cycles
// (~19 s) is a fault of the protocol, not a wait: trap, so that the launch
// fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long start = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - start > (1LL << 35)) __trap();
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one box of a 2-D tensor map (column x, row y) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar) : "memory");
}

// 16 bytes into shared memory; zero-filled past src_bytes (all 16 when 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// bytes (a multiple of 16) from shared to global memory by the bulk copy
// engine, committed as one bulk group of this thread
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile in 128-byte swizzle: 8-row groups 1024
// bytes apart; the K step of 16 values within a swizzle row adds 32 bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define MMG_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, both K-major in shared memory.
// Thread (warp w, lane 4g + t) holds rows 16w + g (d[4j], d[4j + 1]) and
// 16w + g + 8 (d[4j + 2], d[4j + 3]) of columns 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : MMG_ACC8(0), MMG_ACC8(8), MMG_ACC8(16), MMG_ACC8(24), MMG_ACC8(32), MMG_ACC8(40),
        MMG_ACC8(48), MMG_ACC8(56), MMG_ACC8(64), MMG_ACC8(72), MMG_ACC8(80), MMG_ACC8(88),
        MMG_ACC8(96), MMG_ACC8(104), MMG_ACC8(112), MMG_ACC8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef MMG_ACC8

// keep the compiler from moving register reads or writes of d across a wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

struct Tile {
  int e, row0, row_end, n0;
};

// tile index -> its expert, first row, the expert's end and first output column
__device__ __forceinline__ Tile locate(int tile, int n_tiles, int n_out, const int* offsets,
                                       const int* tile_offsets, int experts) {
  const int m = tile / n_tiles;
  int lo = 0, hi = experts;  // tile_offsets[lo] <= m < tile_offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_offsets[mid] <= m) lo = mid; else hi = mid;
  }
  return {lo, offsets[lo] + (m - tile_offsets[lo]) * BM, offsets[lo + 1],
          (tile - m * n_tiles) * n_out};
}

// GATED: A = x [tokens, k] gathered through a_rows, map_b over the gate|up
// weights as [E 2n, k], out = h [R, n].  Else: map_a over h [R, k], map_b
// over the down weights as [E n, k], out [R, n] at row dest[r], scaled by
// row_weights[r].  A tile covers Layout::N_OUT outputs of BM rows.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ a,
                    const int* __restrict__ a_rows, const int* __restrict__ offsets,
                    const int* __restrict__ tile_offsets, const float* __restrict__ row_weights,
                    const int* __restrict__ dest, bf16* __restrict__ out, int experts, int n,
                    int k) {
  using L = Layout<GATED>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle atoms need 1024-byte alignment
  const uint32_t full = base + L::BARRIERS, empty = full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, GATED ? 128 + 1 : 1);  // GATED: each producer thread's copies + the TMA
      bar_init(empty + 8 * s, CONSUMERS * 4);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (n + L::N_OUT - 1) / L::N_OUT;
  const int tiles = tile_offsets[experts] * n_tiles;
  const int ktiles = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == CONSUMERS) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = threadIdx.x - CONSUMERS * 128;
    if (!GATED && p != 0) return;
    // GATED: thread p copies 16-byte chunk p % 8 of rows p / 8 + 16 i, whose
    // swizzled place in a row is the same for every i
    const int chunk = p & 7, r0 = p >> 3;
    const uint32_t a_dst = r0 * 128 + ((chunk ^ (r0 & 7)) << 4);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile t = locate(tile, n_tiles, L::N_OUT, offsets, tile_offsets, experts);
      int src[8];
      if (GATED) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = t.row0 + r0 + 16 * i;
          src[i] = row < t.row_end ? a_rows[row] : -1;
        }
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        const uint32_t sa = base + stage * STAGE_BYTES, sb = sa + A_BYTES;
        const uint32_t bar = full + 8 * stage;
        bar_wait(empty + 8 * stage, phase ^ 1);
        if (GATED) {
          if (p == 0) {
            bar_arrive_expect(bar, B_BYTES);
            tma_load(sb, &map_b, kt * BK, t.e * 2 * n + t.n0, bar);
            tma_load(sb + B_BYTES / 2, &map_b, kt * BK, t.e * 2 * n + n + t.n0, bar);
          }
          const int col = kt * BK + chunk * 8;
          const int bytes = col < k ? 16 : 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool ok = src[i] >= 0 && bytes;
            cp_async16(sa + a_dst + i * 16 * 128, a + (ok ? (size_t)src[i] * k + col : 0),
                       ok ? 16 : 0);
          }
          cp_async_arrive(bar);
        } else {
          bar_arrive_expect(bar, A_BYTES + B_BYTES);
          tma_load(sa, &map_a, kt * BK, t.row0, bar);
          tma_load(sb, &map_b, kt * BK, t.e * n + t.n0, bar);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    if (GATED) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, slab_row = wg * 64 + warp * 16;  // this warp's 16 rows of a tile
  const uint32_t slab = base + L::STAGING + slab_row * L::PITCH;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = locate(tile, n_tiles, L::N_OUT, offsets, tile_offsets, experts);
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t sa = base + stage * STAGE_BYTES;
      bar_wait(full + 8 * stage, phase);
      // cp.async writes are the generic proxy's; wgmma reads through the async proxy
      if (GATED) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint64_t da = smem_desc(sa + wg * 64 * 128), db = smem_desc(sa + A_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wgmma_256(d, da + 2 * ks, db + 2 * ks, kt | ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (lane == 0) bar_arrive(empty + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }

    // Epilogue: the warp rounds its 16 rows into its slab of the staging
    // area, then each of lanes 0..15 sends one row out by a bulk copy, which
    // drains while the next tile's products run.  The slab is written again
    // only after those copies have read it.
    if (lane < 16) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t at = slab + (g + 8 * half) * L::PITCH + 4 * (lane & 3);
      if (GATED) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float* gate = &d[4 * j + 2 * half];
          const float* up = &d[64 + 4 * j + 2 * half];
          st_shared(at + 16 * j, mmg::pack_bf16(silu(gate[0]) * up[0], silu(gate[1]) * up[1]));
        }
      } else {
        const int row = t.row0 + slab_row + g + 8 * half;
        const float w = row < t.row_end ? row_weights[row] : 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float* v = &d[4 * j + 2 * half];
          st_shared(at + 16 * j, mmg::pack_bf16(v[0] * w, v[1] * w));
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the bulk copies read them
    __syncwarp();
    const int row = t.row0 + slab_row + lane;
    if (lane < 16 && row < t.row_end) {
      const int cols = min(L::N_OUT, n - t.n0);
      bulk_store(out + (size_t)(GATED ? row : dest[row]) * n + t.n0, slab + lane * L::PITCH,
                 cols * 2);
    }
  }
  if (lane < 16) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda).
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A map over a row-major bf16 [rows, cols] tensor whose boxes are 64 columns
// (128 bytes) x box_rows rows, 128-byte swizzled, zero past the edges.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool GATED>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const bf16* a,
                   const int* a_rows, const int* offsets, const int* tile_offsets,
                   const float* row_weights, const int* dest, bf16* out, int experts, int n,
                   int k, int max_tiles, cudaStream_t stream) {
  using L = Layout<GATED>;
  const long long tiles = (long long)max_tiles * ((n + L::N_OUT - 1) / L::N_OUT);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_gemm_kernel<GATED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  grouped_gemm_kernel<GATED><<<grid, THREADS, L::BYTES, stream>>>(
      map_a, map_b, a, a_rows, offsets, tile_offsets, row_weights, dest, out, experts, n, k);
  return cudaGetLastError();
}

// nothing to do (true) or a K and N the kernel takes
bool idle(int n, int max_tiles) { return max_tiles <= 0 || n <= 0; }
bool fits(int n, int k) { return k > 0 && k % 8 == 0 && n % 8 == 0; }

}  // namespace

extern "C" {

// x [tokens, d_model] bf16; tokens [R] int32 (the token of each sorted row);
// w_gate_up [experts, 2 width, d_model] bf16; offsets, tile_offsets [experts + 1]
// int32; h [R, width] bf16.
int mmg_moe_gate_up(const void* x, const void* tokens, const void* w_gate_up,
                    const void* offsets, const void* tile_offsets, void* h, int experts,
                    int d_model, int width, int max_tiles, void* stream) {
  if (idle(width, max_tiles)) return cudaSuccess;
  if (!fits(width, d_model)) return cudaErrorInvalidValue;
  CUtensorMap map_b;
  const cudaError_t err = tile_map(&map_b, w_gate_up, 2LL * experts * width, d_model, BN / 2);
  if (err != cudaSuccess) return err;
  return launch<true>(map_b, map_b, static_cast<const bf16*>(x), static_cast<const int*>(tokens),
                      static_cast<const int*>(offsets), static_cast<const int*>(tile_offsets),
                      nullptr, nullptr, static_cast<bf16*>(h), experts, width, d_model,
                      max_tiles, static_cast<cudaStream_t>(stream));
}

// h [rows, width] bf16; w_down [experts, d_model, width] bf16; row_weights
// [rows] float32; dest [rows] int32 (each sorted row's (token, slot) place);
// out [rows, d_model] bf16.
int mmg_moe_down(const void* h, const void* w_down, const void* row_weights, const void* dest,
                 const void* offsets, const void* tile_offsets, void* out, int experts,
                 int d_model, int width, int rows, int max_tiles, void* stream) {
  if (idle(d_model, max_tiles)) return cudaSuccess;
  if (!fits(d_model, width) || rows <= 0) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = tile_map(&map_a, h, rows, width, BM);
  if (err == cudaSuccess) err = tile_map(&map_b, w_down, (long long)experts * d_model, width, BN);
  if (err != cudaSuccess) return err;
  return launch<false>(map_a, map_b, nullptr, nullptr, static_cast<const int*>(offsets),
                       static_cast<const int*>(tile_offsets),
                       static_cast<const float*>(row_weights), static_cast<const int*>(dest),
                       static_cast<bf16*>(out), experts, d_model, width, max_tiles,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
