// The depthwise 7x7 halo tile, for sm_90a: stride 1, SAME zero padding, plus
// bias,
//
//     out[n, y, x, c] = b[c] + sum_{ky, kx} x[n, y + ky - 3, x + kx - 3, c] * w[ky, kx, 0, c]
//
// shared by depthwise_conv.cu (the standalone kernel, output in x's type)
// and fused_block.cu (the ConvNeXt block's front half, output in fp32: the
// hand-off into its LayerNorm).
//
// Layout: x [n, H, W, C] (NHWC, contiguous), w [7, 7, 1, C] (HWIO), b [C],
// all of one type T (float or __nv_bfloat16); out [n, H, W, C] of type TO
// (T or float).  Any H, W >= 1, any C.  Sums in fp32 in the order (ky, kx),
// one rounding to TO.
//
// What bounds it on an H100: 98 operations per output against
// (sizeof(T) + sizeof(TO)) bytes per output moved, so bytes (each input read
// once, each output written once); next comes the fp32 FMA rate (49 FMAs per
// output at 67 TFLOP/s, ~1.2x the byte bound in bf16), then shared-memory
// reads.  Measured on an H100 80GB HBM3 (chip_smoke.py phase 11), the bf16
// stage shapes run at 3.6-7.5x the byte bound and at about 30% of the FMA
// rate: by instruction count the inner loop spends about 3 of 10 issue slots
// on shared-memory reads and bf16 -> fp32 conversions, and the small stages
// (W = 26, 52) waste columns of their 16-wide tiles.
//
// Design: a halo tile in shared memory.  A CTA owns TH x TW output pixels
// of one image and a slice of CS = 32 channels (C = 96, the first stage's,
// splits into whole slices).  It stages the (TH + 6) x (TW + 6) input halo
// of that slice, and the slice's 49 taps, into shared memory with 16-byte
// cp.async; pixels outside the image and channels past C are zero-filled
// by the copy, which is the SAME padding, so no padded copy exists.  The
// CTAs are persistent and double-buffered: each walks tiles with the grid's
// stride and copies its next tile's halo while it computes the current one,
// so the copies of one SM overlap its FMAs.  Thread (r, i) computes row r of
// the tile for the channel pair (2i, 2i + 1) (a float2 / __nv_bfloat162 per
// read; the two rows a warp reads sit 16 banks apart) and all TW outputs of
// that row: per kernel row ky it reads the 7 taps and slides along the
// TW + 6 input pixels, each value feeding up to 7 accumulators.  Lanes past
// C idle; a C whose pixel rows are not 16-byte aligned (odd C, C = 6 in
// bf16) stages the halo with plain loads into the same buffers.
#pragma once

#include "common.cuh"

namespace mmg {
namespace dwtile {

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int TH = 16;                // output rows per tile
constexpr int TW = 16;                // output columns per tile, all in one thread
constexpr int CS = 32;                // channels per tile, a pair per thread
constexpr int PAIRS = CS / 2;
constexpr int HH = TH + KS - 1;       // halo rows
constexpr int HW = TW + KS - 1;       // halo columns
constexpr int THREADS = PAIRS * TH;

// elements per halo row: bf16 rows get 16 words of padding, so the two rows
// a warp reads fall on different banks
template <typename T> __host__ __device__ constexpr int row_elems() {
  return HW * CS + (sizeof(T) == 2 ? 32 : 0);
}
// elements of one buffer: the halo, then the 49 x CS taps
template <typename T> __host__ __device__ constexpr int buffer_elems() {
  return HH * row_elems<T>() + KS * KS * CS;
}
template <typename T> constexpr size_t smem_bytes() { return 2 * buffer_elems<T>() * sizeof(T); }

struct Tile {
  int img, y0, x0, c0;
};

// tile index -> (image, first row, first column, first channel); the slice
// varies slowest, so a CTA's tiles mostly share one slice's taps
__device__ __forceinline__ Tile tile_at(int tile, int n, int tiles_h, int tiles_w) {
  const int tx = tile % tiles_w;
  int rest = tile / tiles_w;
  const int ty = rest % tiles_h;
  rest /= tiles_h;
  return Tile{rest % n, ty * TH, tx * TW, (rest / n) * CS};
}

// Copy one tile's halo and taps into ``buf`` (asynchronously when vec16).
template <typename T>
__device__ __forceinline__ void load_tile(T* buf, const Tile& t, const T* __restrict__ x,
                                          const T* __restrict__ w, int h, int wd, int c,
                                          bool vec16) {
  constexpr int RE = row_elems<T>();
  const T* xi = x + (long long)t.img * h * wd * c;
  T* taps = buf + HH * RE;
  if (vec16) {
    constexpr int E = 16 / sizeof(T);   // channels per 16-byte chunk
    constexpr int CH = CS / E;          // chunks per pixel
    for (int i = threadIdx.x; i < HH * HW * CH; i += THREADS) {
      const int p = i / CH;
      const int j = i - p * CH;
      const int iy = p / HW, ix = p - iy * HW;
      const int gy = t.y0 + iy - HALO, gx = t.x0 + ix - HALO, ch = t.c0 + j * E;
      // C * sizeof(T) % 16 == 0, so a chunk lies wholly inside C or past it
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < c;
      const T* src = ok ? xi + ((long long)gy * wd + gx) * c + ch : x;
      cp_async16(buf + iy * RE + ix * CS + j * E, src, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < KS * KS * CH; i += THREADS) {
      const int k = i / CH;
      const int ch = t.c0 + (i - k * CH) * E;
      const bool ok = ch < c;
      cp_async16(taps + k * CS + (ch - t.c0), ok ? w + (long long)k * c + ch : w, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < HH * HW * CS; i += THREADS) {
      const int p = i / CS;
      const int cl = i - p * CS;
      const int iy = p / HW, ix = p - iy * HW;
      const int gy = t.y0 + iy - HALO, gx = t.x0 + ix - HALO, ch = t.c0 + cl;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < c;
      buf[iy * RE + ix * CS + cl] = ok ? xi[((long long)gy * wd + gx) * c + ch] : from_f<T>(0.0f);
    }
    for (int i = threadIdx.x; i < KS * KS * CS; i += THREADS) {
      const int k = i / CS;
      const int ch = t.c0 + (i - k * CS);
      taps[i] = ch < c ? w[(long long)k * c + ch] : from_f<T>(0.0f);
    }
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS, 3)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
          TO* __restrict__ out, int n, int h, int wd, int c, int tiles_h, int tiles_w, int tiles,
          int vec16) {
  constexpr int RE = row_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int row = threadIdx.x / PAIRS;
  const int cl = 2 * (threadIdx.x % PAIRS);

  int stage = 0;
  if ((int)blockIdx.x < tiles)
    load_tile<T>(bufs, tile_at(blockIdx.x, n, tiles_h, tiles_w), x, w, h, wd, c, vec16);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < tiles)  // the next tile's copy runs under this tile's FMAs
      load_tile<T>(bufs + (stage ^ 1) * buffer_elems<T>(), tile_at(next, n, tiles_h, tiles_w), x,
                   w, h, wd, c, vec16);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const Tile t = tile_at(tile, n, tiles_h, tiles_w);
    const int oy = t.y0 + row, ch = t.c0 + cl;
    if (oy < h && ch < c) {
      const T* halo = bufs + stage * buffer_elems<T>();
      const T* taps = halo + HH * RE;
      float2 acc[TW];
#pragma unroll
      for (int o = 0; o < TW; ++o) acc[o] = make_float2(0.0f, 0.0f);
#pragma unroll 1
      for (int ky = 0; ky < KS; ++ky) {
        float2 tp[KS];
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) tp[kx] = load_pair<T>(taps + (ky * KS + kx) * CS + cl);
        const T* src = halo + (row + ky) * RE + cl;
#pragma unroll
        for (int ix = 0; ix < HW; ++ix) {
          const float2 val = load_pair<T>(src + ix * CS);
#pragma unroll
          for (int kx = 0; kx < KS; ++kx) {
            const int o = ix - kx;  // the output this tap of this input feeds
            if (o >= 0 && o < TW) {
              acc[o].x += val.x * tp[kx].x;
              acc[o].y += val.y * tp[kx].y;
            }
          }
        }
      }

      const bool second = ch + 1 < c;
      const float bx = to_f<T>(b[ch]), by = second ? to_f<T>(b[ch + 1]) : 0.0f;
      TO* orow = out + (((long long)t.img * h + oy) * wd + t.x0) * c + ch;
      const bool paired = second && c % 2 == 0;  // the pair lies on 2 * sizeof(TO) bytes
#pragma unroll
      for (int o = 0; o < TW; ++o) {
        if (t.x0 + o >= wd) break;
        TO* dst = orow + (long long)o * c;
        if (paired) {
          if constexpr (sizeof(TO) == 2) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(acc[o].x + bx, acc[o].y + by);
          } else {
            *reinterpret_cast<float2*>(dst) = make_float2(acc[o].x + bx, acc[o].y + by);
          }
        } else {
          dst[0] = from_f<TO>(acc[o].x + bx);
          if (second) dst[1] = from_f<TO>(acc[o].y + by);
        }
      }
    }
    __syncthreads();  // the copy two tiles ahead overwrites this buffer
    stage ^= 1;
  }
  cp_async_wait<0>();
}

// Launch the halo tile on ``stream`` (persistent grid: at most the CTAs that
// are resident at once).
template <typename T, typename TO>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int n, int h, int wd,
                   int c, cudaStream_t stream) {
  auto kernel = dw_kernel<T, TO>;
  int max_smem = 0, dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_max_smem(kernel, &max_smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const long long tiles = (long long)tiles_w * tiles_h * n * ((c + CS - 1) / CS);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec16 = (c * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<TO*>(out), n, h, wd, c, tiles_h, tiles_w, (int)tiles, vec16 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace dwtile
}  // namespace mmg
