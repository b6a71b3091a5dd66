// Ring all-gather of P per-rank shards, for sm_90a:
//
//     out[r] = concat(shard[0], ..., shard[P-1])      for every rank r
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/parallel/collectives.py
// (`ring_all_gather` / `_ring_all_gather_kernel`), a unidirectional ring of
// remote DMAs between chips in which every step lands in a distinct output
// slot and has its own send/recv semaphore pair.  Here the P ranks are P
// (shard, output) buffer pairs reached through device pointers; on one card
// they are P logical ranks, and the same body given peer pointers to other
// cards' buffers is the multi-card ring (its fences and flags would then take
// the .sys scope; that transport is not wired up).
//
// The schedule is the TPU kernel's:
//   rank r copies its shard into slot r of its own output;
//   for step i = 0 .. P-2, rank r forwards slot (r - i) mod P of its output
//   into the same slot of rank (r + 1) mod P's output, then signals that
//   receiver's flag of step i.  Before step i >= 1 it waits for its own flag
//   of step i - 1: the chunk it forwards at step i is the one its left
//   neighbour delivered at step i - 1.
// Every slot of every output is written exactly once, and every (receiver,
// step, block) has its own flag, so no slot or flag is reused within a call.
//
// Grid (B, P), launched cooperatively so that all B * P blocks are resident
// (or the launch fails; it never hangs on a block that cannot be scheduled).
// Block b of every rank moves only segment b of each chunk, so it waits only
// on block b of its left neighbour.  Stores are 16 bytes wide where the chunk
// size and every pointer allow (V = uint4), else the widest that divides.
//
// Signalling: after its stores every thread fences (__threadfence), the
// block synchronises, and one thread release-stores the generation number
// into the receiver's flag; the receiver's thread 0 acquire-loads that flag
// until it equals the generation, fences, and the block synchronises before
// it reads the chunk (with ld.global.cg: L2, never a stale L1 line).  The
// host passes a rising generation per call, so no flag is ever cleared.
// A wait that passes `timeout_ns` on %globaltimer (about 1 s by default)
// stores the generation into the error word and the block leaves; the other
// waiters see the word and leave too.  The host reads the word (after one
// call, or once after a loss's gathers) and raises, so a protocol fault
// fails the caller instead of hanging the card.
//
// What bounds it: pure data movement.  The function reads P shards and
// writes P outputs of P chunks, (P * P + P) * chunk bytes; the bound is that
// over HBM bandwidth.  The ring's own schedule also reads the P * P - P
// forwarded chunks back out of the outputs (2 * P * P * chunk bytes in all),
// which is overhead against the bound.  The flag hand-offs serialise the
// P-1 steps, which at the training shapes (64 KB chunks) cost more than the
// bytes; a later PR can pipeline sub-chunks across steps.

#include "common.cuh"

namespace {

constexpr int MAX_RANKS = 64;
constexpr int THREADS = 256;

struct RingPtrs {
  const unsigned char* src[MAX_RANKS];
  unsigned char* dst[MAX_RANKS];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename V>
__device__ __forceinline__ void copy_segment(V* __restrict__ dst, const V* __restrict__ src,
                                             long long lo, long long hi) {
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) dst[i] = __ldcg(src + i);
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
ring_all_gather_kernel(RingPtrs ptrs, int ranks, long long n, long long seg, unsigned* flags,
                       unsigned* error, unsigned gen, long long timeout_ns, int drop_step) {
  const int b = blockIdx.x, r = blockIdx.y, nblk = gridDim.x;
  const long long lo = min(n, (long long)b * seg), hi = min(n, lo + seg);
  const V* src = reinterpret_cast<const V*>(ptrs.src[r]);
  V* mine = reinterpret_cast<V*>(ptrs.dst[r]);
  const int right = (r + 1) % ranks;
  V* next = reinterpret_cast<V*>(ptrs.dst[right]);
  __shared__ int failed;

  copy_segment(mine + (long long)r * n, src, lo, hi);  // own shard -> slot r
  __threadfence();
  __syncthreads();

  for (int step = 0; step < ranks - 1; ++step) {
    const long long slot = (r - step + ranks) % ranks;
    if (step > 0) {
      if (threadIdx.x == 0) {
        const unsigned* flag = flags + ((long long)r * (ranks - 1) + step - 1) * nblk + b;
        const unsigned long long start = globaltimer_ns();
        int ok = 1;
        while (ld_acquire(flag) != gen) {
          if (*reinterpret_cast<volatile unsigned*>(error) == gen) {  // another block gave up
            ok = 0;
            break;
          }
          if ((long long)(globaltimer_ns() - start) > timeout_ns) {
            atomicExch(error, gen);
            ok = 0;
            break;
          }
        }
        __threadfence();
        failed = !ok;
      }
      __syncthreads();
      if (failed) return;
    }
    copy_segment(next + slot * n, mine + slot * n, lo, hi);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 && step != drop_step)
      st_release(flags + ((long long)right * (ranks - 1) + step) * nblk + b, gen);
  }
}

template <typename V>
cudaError_t launch(const RingPtrs& ptrs, int ranks, long long chunk_bytes, int blocks,
                   unsigned* flags, unsigned* error, unsigned gen, long long timeout_ns,
                   int drop_step, cudaStream_t stream) {
  RingPtrs p = ptrs;
  long long n = chunk_bytes / (long long)sizeof(V);
  long long seg = (n + blocks - 1) / blocks;
  void* args[] = {&p, &ranks, &n, &seg, &flags, &error, &gen, &timeout_ns, &drop_step};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)ring_all_gather_kernel<V>,
                                                dim3(blocks, ranks), dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename V>
cudaError_t max_blocks(int ranks, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_all_gather_kernel<V>, THREADS, 0);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms / ranks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks per rank that a cooperative launch of `ranks` ranks keeps resident,
// for a vector width of `vec_bytes` (16, 8, 4, 2 or 1).
int mmg_ring_max_blocks(int ranks, int vec_bytes, int* out) {
  if (ranks < 1 || ranks > MAX_RANKS) return (int)cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: return (int)max_blocks<uint4>(ranks, out);
    case 8: return (int)max_blocks<uint2>(ranks, out);
    case 4: return (int)max_blocks<unsigned>(ranks, out);
    case 2: return (int)max_blocks<unsigned short>(ranks, out);
    case 1: return (int)max_blocks<unsigned char>(ranks, out);
  }
  return (int)cudaErrorInvalidValue;
}

// srcs / dsts: `ranks` device pointers each (shards of chunk_bytes, outputs of
// ranks * chunk_bytes).  flags: ranks * (ranks - 1) * blocks words, error: one
// word, both device memory that persists across calls; gen: this call's
// generation (never 0, rising per call).  drop_step >= 0 withholds every
// rank's signal of that step (a test of the timeout path).  Returns a
// cudaError_t (0 = success); a protocol timeout is reported in *error.
int mmg_ring_all_gather(const unsigned long long* srcs, const unsigned long long* dsts, int ranks,
                        long long chunk_bytes, int vec_bytes, int blocks, void* flags,
                        void* error, unsigned gen, long long timeout_ns, int drop_step,
                        void* stream) {
  if (ranks < 1 || ranks > MAX_RANKS || chunk_bytes <= 0 || blocks < 1 || gen == 0 ||
      vec_bytes <= 0 || chunk_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  RingPtrs ptrs;
  for (int i = 0; i < ranks; ++i) {
    ptrs.src[i] = reinterpret_cast<const unsigned char*>(srcs[i]);
    ptrs.dst[i] = reinterpret_cast<unsigned char*>(dsts[i]);
  }
  unsigned* f = static_cast<unsigned*>(flags);
  unsigned* e = static_cast<unsigned*>(error);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return (int)launch<uint4>(ptrs, ranks, chunk_bytes, blocks, f, e, gen, timeout_ns, drop_step, s);
    case 8: return (int)launch<uint2>(ptrs, ranks, chunk_bytes, blocks, f, e, gen, timeout_ns, drop_step, s);
    case 4: return (int)launch<unsigned>(ptrs, ranks, chunk_bytes, blocks, f, e, gen, timeout_ns, drop_step, s);
    case 2: return (int)launch<unsigned short>(ptrs, ranks, chunk_bytes, blocks, f, e, gen, timeout_ns, drop_step, s);
    case 1: return (int)launch<unsigned char>(ptrs, ranks, chunk_bytes, blocks, f, e, gen, timeout_ns, drop_step, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
