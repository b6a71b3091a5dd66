// JAX's threefry2x32 PRNG and flax's dropout, bit for bit, on the card.
//
// Two entry points:
//
// * mmg_threefry2x32: the Threefry-2x32 hash (20 rounds, the key schedule
//   of jax/_src/prng.py's _threefry2x32_lowering) of the counters
//   base, base + 1, ..., base + n - 1, each split into its (hi, lo) 32-bit
//   words, under the key read from device memory.  out[i] = (word 0,
//   word 1).  With base = 0 that is jax.random.split(key, n) (the
//   partitionable, fold-like split); with base = data and n = 1 it is
//   jax.random.fold_in(key, data).
// * mmg_dropout: flax's nn.Dropout in one pass.  The dropout key is
//   fold_in(key, fold), fold the uint32 that flax's make_rng folds in for
//   the Dropout's scope (SHA-1 of its path, computed on the host).  Element
//   i draws 32 bits as the xor of the two hash words of counter i (the
//   partitionable random_bits), turns them into a uniform in [0, 1) as
//   jax.random.uniform does ((bits >> 9) | 0x3F800000, as fp32, minus 1),
//   keeps the element where uniform < keep, and writes x / keep (IEEE
//   division, not a multiply by the reciprocal) or 0, plus the mask byte
//   the backward reads.
//
// Keys are int64 pairs holding uint32 words (the port's layout).  Integer
// arithmetic wraps modulo 2^32 as in XLA; the uniform and the quotient are
// rounded to nearest, so the masks and outputs equal the plain version's
// (mmgclip_tpu_torch/utils/prng.py) and flax's on the CPU.

#include "common.cuh"

namespace {

constexpr uint32_t KS_PARITY = 0x1BD11BDAu;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return __funnelshift_l(x, x, d); }

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32 of the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

__global__ void threefry_kernel(const int64_t* __restrict__ key, long long base, long long n,
                                int64_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long c = (unsigned long long)(base + i);
  uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
  threefry((uint32_t)key[0], (uint32_t)key[1], x0, x1);
  out[2 * i] = x0;
  out[2 * i + 1] = x1;
}

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, const int64_t* __restrict__ key,
                               uint32_t fold, float keep, long long n, T* __restrict__ y,
                               uint8_t* __restrict__ mask) {
  __shared__ uint32_t dkey[2];
  if (threadIdx.x == 0) {  // fold_in(key, fold): the counter (0, fold)
    uint32_t a = 0u, b = fold;
    threefry((uint32_t)key[0], (uint32_t)key[1], a, b);
    dkey[0] = a;
    dkey[1] = b;
  }
  __syncthreads();
  const uint32_t k0 = dkey[0], k1 = dkey[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32), x1 = (uint32_t)i;
    threefry(k0, k1, x0, x1);
    const float u = __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
    const bool kept = u < keep;
    y[i] = mmg::from_f<T>(kept ? __fdiv_rn(mmg::to_f<T>(x[i]), keep) : 0.0f);
    mask[i] = kept ? 1 : 0;
  }
}

// a grid-stride loop past 8 CTAs for each of an H100's 132 SMs (no API call
// here: the launch may be under CUDA graph capture)
constexpr long long MAX_BLOCKS = 8LL * 132;

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// out: int64 [n, 2]; key: int64 [2] on the device; 0 <= base.  Returns a cudaError_t.
int mmg_threefry2x32(const void* key, long long base, long long n, void* out, void* stream) {
  if (n <= 0 || base < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  threefry_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const int64_t*>(key), base, n,
                                             static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  x, y: n values; mask: n bytes; key:
// int64 [2].  0 < keep <= 1.  Returns a cudaError_t.
int mmg_dropout(int dtype, const void* x, const void* key, unsigned fold, float keep, long long n,
                void* y, void* mask, void* stream) {
  if (n <= 0 || !(keep > 0.0f && keep <= 1.0f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  const int64_t* k = static_cast<const int64_t*>(key);
  uint8_t* m = static_cast<uint8_t*>(mask);
  if (dtype == 0) {
    dropout_kernel<float><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(x), k, fold, keep, n,
                                                     static_cast<float*>(y), m);
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    dropout_kernel<bf16><<<blocks, THREADS, 0, s>>>(static_cast<const bf16*>(x), k, fold, keep, n,
                                                    static_cast<bf16*>(y), m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
