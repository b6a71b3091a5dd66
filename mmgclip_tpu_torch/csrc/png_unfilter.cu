// Undo the PNG row filters of a batch of grayscale images on the card, for
// sm_90a:
//
//     rows [n, h, 1 + w * bpp] uint8 (filter byte, then the filtered bytes)
//       -> out [n, h, w]: uint16 in native byte order (bpp 2, 16-bit
//          samples stored big-endian in the file), or uint8 (bpp 1)
//
// Replaces no TPU kernel: the JAX package unfilters rows inside libpng on
// the host (native/png_decode.cc).  The port's decode threads used to do the
// same in csrc/png_unfilter.c, about half of every decode of a full-field
// image; this kernel takes that work off the host for the files that reach
// the card as filtered rows (ingest/png_reader.py::read_png_rows).
//
// The five filters (None, Sub, Up, Average, Paeth) may differ from row to
// row.  Arithmetic is the PNG standard's and png_unfilter.c's, in integers,
// so the pixels are bit-equal to the host's: sums modulo 256, Average as
// (left + up) >> 1, Paeth ties broken left, then up, then up-left; zeros
// left of the first pixel and above the first row.  The caller checks the
// filter bytes on the host (every byte is 0-4); the kernel takes any other
// byte as None.  A zero row (filter byte 0) gives zeros, so pad images are
// free of special cases.
//
// What bounds it.  The bytes are few (2 x 281 MB for a batch of 32
// 2294 x 1914 16-bit images: 0.17 ms at 3.35 TB/s); the work is a chain.
// Byte x of a row needs byte x - bpp of the same row (Sub, Average, Paeth)
// and bytes x and x - bpp of the row above, so an image's critical path is
// h + w dependent steps, and each step is some 15 integer operations a byte.
// The design is a wavefront:
//
// * One CTA per image, 16 warps.  A warp takes a band of 32 rows, one row a
//   lane (bands warp, warp + 16, ...).  In step s lane t unfilters pixel
//   x = s - t of its row: the row above is one pixel ahead, so the pixel
//   above arrives from lane t - 1 by one shuffle of its previous output,
//   the up-left pixel is this lane's previous "up", the left pixel its own
//   previous output.  A pixel's bpp byte lanes run side by side in one
//   thread; rows run side by side in the warp; bands run side by side in
//   the CTA.
// * The band's filtered bytes are staged through shared memory, 64 pixels
//   at a time (a step block), in a ring of two chunks a row.  The next
//   chunk is loaded into registers as aligned 4-byte words (the rows start
//   at any byte) while the current block's steps run, then placed in its
//   slot; finished pixels leave by coalesced rows.  The skewed reads of the
//   wavefront hit 32 banks (row pitch = ring + bpp + 4 bytes).  Each pixel
//   is unfiltered in place, swapped to native order in the same pass.
//   Where every row of a band is Paeth, the steps skip the other
//   predictors.
// * Lane 0's row above is the last row of the band before, handled by
//   another warp one or more step blocks ahead.  That warp stores each
//   finished chunk to the output and then publishes the columns stored; the
//   waiting warp reads the row's next chunk back from device memory (L2)
//   once it has been published.  A band only waits on the band before it,
//   and each warp takes its bands in order, so the lowest unfinished band
//   always progresses.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // pixels a step block advances; >= 32, so a chunk
                            // is finished for every lane one block later

template <int BPP>
struct Tile {
  static constexpr int kRing = 2 * kChunk * BPP;       // bytes of two chunks, a multiple of 128
  static constexpr int kPitch = kRing + BPP + 4;       // skewed reads: one bank a lane
  static constexpr int kRows = 32 * kPitch;            // the band's ring
  static constexpr int kWarpBytes = kRows + kChunk * BPP;  // + the chunk of the row above
  static constexpr int kBytes = 16 * kWarps + kWarps * kWarpBytes;  // + progress words
};

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// the predictor of one byte: a left, b up, c up-left; KIND >= 0 fixes the
// filter for the whole band, KIND < 0 reads each lane's ``kind``
template <int KIND>
__device__ __forceinline__ int predict(int kind, int a, int b, int c) {
  if (KIND == 4) return paeth(a, b, c);
  const int p = paeth(a, b, c);
  const int avg = (a + b) >> 1;
  return kind == 4 ? p : kind == 3 ? avg : kind == 2 ? b : kind == 1 ? a : 0;
}

// a pixel's bytes in file order (byte 0 first) <-> the pixel as stored
// here: native uint16 (byte 0 is the high byte) or the byte itself
template <int BPP> __device__ __forceinline__ int byte_of(unsigned pixel, int j) {
  return BPP == 2 ? (j == 0 ? (int)(pixel >> 8) : (int)(pixel & 0xFF)) : (int)pixel;
}

template <int BPP> __device__ __forceinline__ unsigned load_px(const unsigned char* p) {
  if (BPP == 2) return *reinterpret_cast<const unsigned short*>(p);
  return *p;
}

template <int BPP> __device__ __forceinline__ void store_px(unsigned char* p, unsigned v) {
  if (BPP == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)v;
  } else {
    *p = (unsigned char)v;
  }
}

// One chunk of a band's filtered rows in registers, loaded as aligned 4-byte
// words (a row's bytes start at any offset: the pitch is odd).  A row's span
// of kChunk * BPP bytes lies in kWords + 1 words from its aligned start: load
// q covers rows q * kRowsPerLoad + lane / kWords, word lane % kWords; the
// last word of row ``lane`` is ``tail``.
template <int BPP>
struct Chunk {
  static constexpr int kWords = kChunk * BPP / 4;
  static constexpr int kRowsPerLoad = 32 / kWords;
  static constexpr int kLoads = 32 / kRowsPerLoad;
  unsigned word[kLoads];
  unsigned tail;
};

// The row's span of chunk bytes [x0 * BPP, x0 * BPP + bytes): its aligned
// first word and the span's offset in it
__device__ __forceinline__ const unsigned* span_words(const unsigned char* row, int x0b, int& off) {
  const unsigned char* first = row + 1 + x0b;
  off = (int)(reinterpret_cast<uintptr_t>(first) & 3);
  return reinterpret_cast<const unsigned*>(first - off);
}

// the 64 steps of one block: lane t on pixel s - t
template <int BPP, int KIND>
__device__ __forceinline__ void wavefront(int s0, int lane, int w, int kind,
                                          const unsigned char* above, unsigned char* mine,
                                          int (&a)[BPP], int (&c)[BPP], unsigned& last) {
#pragma unroll 4
  for (int s = s0; s < s0 + kChunk; ++s) {
    const int x = s - lane;
    unsigned up = __shfl_up_sync(0xffffffffu, last, 1);
    if (lane == 0 && s < w) up = load_px<BPP>(above + (s - s0) * BPP);
    if (x >= 0 && x < w) {
      const int at = (x & (2 * kChunk - 1)) * BPP;
      const unsigned f = load_px<BPP>(mine + at);
      unsigned px = 0;
#pragma unroll
      for (int j = 0; j < BPP; ++j) {
        const int b = byte_of<BPP>(up, j);
        // file byte j of the filtered pixel: byte j in memory order
        const int fb = BPP == 2 ? (int)((f >> (8 * j)) & 0xFF) : (int)f;
        const int v = (fb + predict<KIND>(kind, a[j], b, c[j])) & 0xFF;
        a[j] = v;
        c[j] = b;
        px = BPP == 2 ? (px | ((unsigned)v << (8 * (1 - j)))) : (unsigned)v;
      }
      store_px<BPP>(mine + at, px);
      last = px;
    }
  }
}

template <int BPP>
__global__ void __launch_bounds__(kThreads, 1)
unfilter_kernel(const unsigned char* __restrict__ rows, unsigned char* out, int h, int w) {
  using T = Tile<BPP>;
  using C = Chunk<BPP>;
  extern __shared__ __align__(16) unsigned char smem[];
  volatile long long* done = reinterpret_cast<volatile long long*>(smem);  // per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + 16 * kWarps + warp * T::kWarpBytes;
  unsigned char* above = ring + T::kRows;
  const long long stride = (long long)w * BPP, pitch = stride + 1;
  const unsigned char* src = rows + (long long)blockIdx.x * h * pitch;
  unsigned char* dst = out + (long long)blockIdx.x * h * stride;
  const int bands = (h + 31) / 32;
  const int chunks = (w + kChunk - 1) / kChunk;
  const int blocks = (w + 31 + kChunk - 1) / kChunk;  // step blocks a band takes
  if (threadIdx.x < kWarps) done[threadIdx.x] = -1;
  __syncthreads();

  for (int band = warp; band < bands; band += kWarps) {
    const int y0 = band * 32;
    const int rows_here = min(32, h - y0);
    const int kind = lane < rows_here ? src[(y0 + lane) * pitch] : 0;
    // one filter for every row of the band (Paeth, as smooth images mostly
    // have): the steps skip the other predictors
    const bool all_paeth = __all_sync(0xffffffffu, kind == 4);
    unsigned char* mine = ring + lane * T::kPitch;  // this lane's row in the ring
    int a[BPP], c[BPP];  // left and up-left bytes
#pragma unroll
    for (int j = 0; j < BPP; ++j) a[j] = c[j] = 0;
    unsigned last = 0;  // this lane's previous output pixel
    C next;

    // start the loads of chunk q's filtered bytes into ``next``
    auto fetch = [&](int q) {
      const int x0b = q * kChunk * BPP, bytes = min(kChunk, w - q * kChunk) * BPP;
#pragma unroll
      for (int i = 0; i < C::kLoads; ++i) {
        const int r = i * C::kRowsPerLoad + lane / C::kWords, wi = lane % C::kWords;
        int off = 0;
        const unsigned* words = r < rows_here ? span_words(src + (long long)(y0 + r) * pitch, x0b, off) : nullptr;
        next.word[i] = words && 4 * wi - off < bytes ? __ldg(words + wi) : 0u;
      }
      int off = 0;
      const unsigned* words = lane < rows_here ? span_words(src + (long long)(y0 + lane) * pitch, x0b, off) : nullptr;
      next.tail = words && 4 * C::kWords - off < bytes ? __ldg(words + C::kWords) : 0u;
    };
    // write ``next`` (chunk q) into its ring slot
    auto put = [&](int q) {
      const int x0b = q * kChunk * BPP, bytes = min(kChunk, w - q * kChunk) * BPP;
      const int slot = (q & 1) * kChunk * BPP;
      auto place = [&](int r, int wi, unsigned v) {
        if (r >= rows_here) return;
        int off = 0;
        span_words(src + (long long)(y0 + r) * pitch, x0b, off);
        unsigned char* to = ring + r * T::kPitch + slot;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * wi + j - off;
          if (i >= 0 && i < bytes) to[i] = (unsigned char)(v >> (8 * j));
        }
      };
#pragma unroll
      for (int i = 0; i < C::kLoads; ++i)
        place(i * C::kRowsPerLoad + lane / C::kWords, lane % C::kWords, next.word[i]);
      place(lane, C::kWords, next.tail);
    };
    // store chunk q (finished for every lane) of the band's rows
    auto store_chunk = [&](int q) {
      const int x0 = q * kChunk, cols = min(kChunk, w - x0);
      const int slot = (q & 1) * kChunk * BPP;
      for (int r = 0; r < rows_here; ++r) {
        const unsigned char* from = ring + r * T::kPitch + slot;
        unsigned char* to = dst + (long long)(y0 + r) * stride + (long long)x0 * BPP;
        for (int i = lane; i < cols; i += 32) store_px<BPP>(to + i * BPP, load_px<BPP>(from + i * BPP));
      }
    };
    auto publish = [&](int cols) {
      __threadfence();  // this lane's stores, before the count that announces them
      __syncwarp();
      if (lane == 0) done[warp] = ((long long)band << 32) | cols;
    };

    fetch(0);
    put(0);
    for (int k = 0; k < blocks; ++k) {
      // (1) the next chunk's loads, in flight through this block's steps
      if (k + 1 < chunks) fetch(k + 1);
      // (2) chunk k of the row above the band: zeros above the image, else
      // the band before's last row once its warp has stored that far
      if (k < chunks) {
        const int x0 = k * kChunk, cols = min(kChunk, w - x0);
        unsigned v[kChunk / 32];
        if (band > 0) {
          if (lane == 0) {
            const long long need = ((long long)(band - 1) << 32) | (x0 + cols);
            const int other = (band - 1) % kWarps;
            while (done[other] < need) __nanosleep(32);
            __threadfence();
          }
          __syncwarp();
        }
        const unsigned char* from = dst + (long long)(y0 - 1) * stride + (long long)x0 * BPP;
#pragma unroll
        for (int q = 0; q < kChunk / 32; ++q) {
          const int i = lane + 32 * q;
          if (band == 0 || i >= cols) {
            v[q] = 0;
          } else if (BPP == 2) {
            v[q] = __ldcg(reinterpret_cast<const unsigned short*>(from + i * BPP));
          } else {
            v[q] = __ldcg(from + i);
          }
        }
#pragma unroll
        for (int q = 0; q < kChunk / 32; ++q)
          if (lane + 32 * q < cols) store_px<BPP>(above + (lane + 32 * q) * BPP, v[q]);
      }
      __syncwarp();

      // (3) the wavefront
      if (all_paeth) {
        wavefront<BPP, 4>(k * kChunk, lane, w, kind, above, mine, a, c, last);
      } else {
        wavefront<BPP, -1>(k * kChunk, lane, w, kind, above, mine, a, c, last);
      }
      __syncwarp();

      // (4) chunk k - 1 is finished for every lane (chunk k too after the
      // last block): store it, put chunk k + 1 in its slot, then announce
      // the columns stored
      if (k >= 1 && k - 1 < chunks) store_chunk(k - 1);
      if (k == blocks - 1 && k < chunks) store_chunk(k);
      __syncwarp();  // the ring slot of chunk k - 1 is free for chunk k + 1
      if (k + 1 < chunks) put(k + 1);
      publish(min(w, (k == blocks - 1 ? k + 1 : k) * kChunk));
    }
    __syncwarp();
  }
}

template <int BPP>
cudaError_t run(const void* rows, void* out, int n, int h, int w, cudaStream_t stream) {
  auto kernel = unfilter_kernel<BPP>;
  const int smem = Tile<BPP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n, kThreads, smem, stream>>>(static_cast<const unsigned char*>(rows),
                                         static_cast<unsigned char*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: [n, h, 1 + w * bpp] uint8; out: [n, h, w] uint16 (bpp 2) or uint8
// (bpp 1).  Returns a cudaError_t (0 = success).
int mmg_png_unfilter_rows(const void* rows, void* out, int n, int h, int w, int bpp,
                          void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bpp == 2) return (int)run<2>(rows, out, n, h, w, s);
  if (bpp == 1) return (int)run<1>(rows, out, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
