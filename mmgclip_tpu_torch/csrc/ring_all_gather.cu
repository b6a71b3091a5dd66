// All-gather of P per-rank shards along dim 0, for sm_90a:
//
//     out[r] = concat(shard[0], ..., shard[P-1])      for every rank r
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/parallel/collectives.py
// (`ring_all_gather` / `_ring_all_gather_kernel`, :58-99 and :189-249), a
// unidirectional ring of remote DMAs between chips in which every step lands
// in a distinct output slot and has its own send/recv semaphore pair.  The
// source has two modes.
//
// ---- Across processes (mmg_ring_peer_scatter and its helpers) ----------
// One rank per process, each process with its own CUDA context (one card
// each in a node; on one card the processes time-slice the card).  Each
// rank's workspace is one cudaMalloc block exported with cudaIpcGetMemHandle
// and mapped by every peer with cudaIpcOpenMemHandle (the host side,
// parallel/collectives.py, swaps the 64-byte handles through the process
// group (all_gather_object) once per (group, size class) and closes the
// mappings before any block is freed).  A workspace holds a header of flag words and
// two buffers of P slots; call g uses buffer g % 2.
//
// Nothing waits for another process inside a kernel: processes on one card
// are not co-resident, so a kernel spinning on a peer's flag would hold the
// card's time slice the peer needs.  A hand-off is instead
//   sender:   mmg_ring_peer_scatter, one launch whose blocks copy the chunk
//             into each target slot (16-byte vectors where sizes allow), then
//             the last block to finish (a counter in the sender's own header)
//             runs fence.acq_rel.sys and st.release.sys of the call's
//             generation into each target's flag word;
//   receiver: mmg_ring_wait, cuStreamWaitValue32(flag >= generation) on its
//             own stream, so the card's front end holds only the receiver's
//             later work; then mmg_ring_copy_out copies its P slots into the
//             caller's output tensor.
// Generations rise per call and flags are never cleared.  The wait has no
// timeout of its own: the host polls an event after the copy-out and, past
// its deadline, raises the flags itself (mmg_ring_release, on another
// stream; every kernel of this mode is loaded when the workspace is made,
// since a lazily loaded kernel's first launch waits for the held context)
// so the stream drains, and raises.  A dead peer therefore fails the
// survivors instead of hanging them.
//
// Buffer reuse needs no acknowledgement: a sender writes buffer g % 2 of a
// peer only after its own call g - 1 completed, which needed data that the
// peer sent after finishing its call g - 2 (stream order), the last reader
// of that buffer.
//
// The schedule is one hop, chosen for NVSwitch, where every pair of cards has
// a direct link: one scatter launch writes slot r of every rank's buffer and
// raises one flag per peer; the receiver waits for P - 1 flags.  One hand-off
// latency per call.  The TPU kernel's ring (P - 1 forwarding steps, each a
// wait and a launch, optionally in pipelined sub-chunks) was built from the
// same calls and timed beside it: as fast at P = 2 and about half as fast at
// P = 4 on one H100 (PERF.md §6), so it was not kept.
// What bounds it: data movement, (P * P + P) * chunk bytes in all (each
// shard read once, each output written once); the copy-out adds 2 * P *
// chunk per rank, and at the training shapes ([32 / P, 512] fp32 a rank)
// the hand-off latency, not the bytes, dominates (PERF.md §6).
//
// ---- In one process (mmg_ring_all_gather) ---------------------------------
// P logical ranks, P (shard, output) buffer pairs reached through device
// pointers, the TPU kernel's schedule run in one cooperative launch:
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
// The blocks are co-resident, so here a bounded spin is the wait:
// after its stores every thread fences (__threadfence), the
// block synchronises, and one thread release-stores the generation number
// into the receiver's flag; the receiver's thread 0 acquire-loads that flag
// until it equals the generation, fences, and the block synchronises before
// it reads the chunk (with ld.global.cg: L2, never a stale L1 line).
// A wait that passes `timeout_ns` on %globaltimer (about 1 s by default)
// stores the generation into the error word and the block leaves; the other
// waiters see the word and leave too.  The host reads the word (after one
// call, or once after a loss's gathers) and raises.  This mode also reads
// the P * P - P forwarded chunks back out of the outputs (2 * P * P * chunk
// bytes in all), and its flag hand-offs serialise the P - 1 steps.

#include "common.cuh"

#include <dlfcn.h>
#include <string.h>

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

// ---- across processes --------------------------------------------------------

struct Targets {
  unsigned char* dst[MAX_RANKS];
  unsigned* flag[MAX_RANKS];  // nullptr: no hand-off for that target (the sender's own slot)
};

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel_sys() { asm volatile("fence.acq_rel.sys;" ::: "memory"); }

// Block (b, t) copies segment b of the chunk into target t; the last block to
// finish raises every target's flag to `gen`.
template <typename V>
__global__ void __launch_bounds__(THREADS)
peer_scatter_kernel(const V* __restrict__ src, long long n, long long seg, Targets targets,
                    int ntargets, unsigned* counter, unsigned gen) {
  const int b = blockIdx.x, t = blockIdx.y;
  const long long lo = min(n, (long long)b * seg), hi = min(n, lo + seg);
  V* dst = reinterpret_cast<V*>(targets.dst[t]);
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) dst[i] = src[i];
  __threadfence_system();  // this thread's stores, before the block counts itself done
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *counter = 0;  // the next launch on this stream starts from 0
  fence_acq_rel_sys();  // every block's stores happen before the flags below
  for (int k = threadIdx.x; k < ntargets; k += THREADS)
    if (targets.flag[k] != nullptr) st_release_sys(targets.flag[k], gen);
}

template <typename V>
cudaError_t launch_scatter(const void* src, long long chunk_bytes, int blocks, const Targets& targets,
                           int ntargets, unsigned* counter, unsigned gen, cudaStream_t stream) {
  long long n = chunk_bytes / (long long)sizeof(V);
  long long seg = (n + blocks - 1) / blocks;
  peer_scatter_kernel<V><<<dim3(blocks, ntargets), THREADS, 0, stream>>>(
      static_cast<const V*>(src), n, seg, targets, ntargets, counter, gen);
  return cudaGetLastError();
}

struct FlagList {
  unsigned* flag[MAX_RANKS];
};

__global__ void release_kernel(FlagList flags, int count, unsigned gen) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) st_release_sys(flags.flag[k], gen);
}

// cuStreamWaitValue32 from libcuda.so.1, which the process has already loaded
// (no link to libcuda at build time); CUresult cuStreamWaitValue32_v2(CUstream,
// CUdeviceptr, cuuint32_t, unsigned int).
typedef int (*StreamWaitFn)(cudaStream_t, unsigned long long, unsigned, unsigned);
typedef int (*DeviceAttrFn)(int*, int, int);
constexpr unsigned CU_STREAM_WAIT_VALUE_GEQ = 0x0;
constexpr int CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1 = 92;
constexpr int CU_RESULT_BASE = 100000;  // a CUresult r is returned as CU_RESULT_BASE + r

void* libcuda_symbol(const char* name) {
  static void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
  return lib == nullptr ? nullptr : dlsym(lib, name);
}

StreamWaitFn stream_wait_fn() {
  static StreamWaitFn fn = [] {
    void* p = libcuda_symbol("cuStreamWaitValue32_v2");
    if (p == nullptr) p = libcuda_symbol("cuStreamWaitValue32");
    return reinterpret_cast<StreamWaitFn>(p);
  }();
  return fn;
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

// ---- across processes -------------------------------------------------------

// A zeroed device block of `bytes` for this rank's workspace and its IPC
// handle (64 bytes into handle_out).  It also loads every kernel of the
// cross-process mode: under lazy loading a kernel's first launch waits for
// the context to go idle, which a stream held by cuStreamWaitValue32 never
// does until that very kernel (the release) has run.
int mmg_ring_ipc_alloc(long long bytes, void* ptr_out, void* handle_out) {
  cudaFuncAttributes attr;
  const void* kernels[] = {(const void*)peer_scatter_kernel<uint4>, (const void*)peer_scatter_kernel<uint2>,
                           (const void*)peer_scatter_kernel<unsigned>,
                           (const void*)peer_scatter_kernel<unsigned short>,
                           (const void*)peer_scatter_kernel<unsigned char>, (const void*)release_kernel};
  for (const void* k : kernels) {
    cudaError_t loaded = cudaFuncGetAttributes(&attr, k);
    if (loaded != cudaSuccess) return (int)loaded;
  }
  void* ptr = nullptr;
  cudaError_t err = cudaMalloc(&ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();  // zeros before any peer maps it
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle_out), ptr);
  if (err != cudaSuccess) {
    if (ptr != nullptr) cudaFree(ptr);
    return (int)err;
  }
  *static_cast<void**>(ptr_out) = ptr;
  return 0;
}

// Map a peer's workspace from its 64-byte handle.
int mmg_ring_ipc_open(void* handle, void* ptr_out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(static_cast<void**>(ptr_out), h, cudaIpcMemLazyEnablePeerAccess);
}

int mmg_ring_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int mmg_ring_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// Whether libcuda offers stream waits on memory: *have_wait = 1 when
// cuStreamWaitValue32 resolves; *attr_v1 = CAN_USE_STREAM_MEM_OPS_V1.
int mmg_ring_stream_ops(int* attr_v1, int* have_wait) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  *have_wait = stream_wait_fn() != nullptr;
  *attr_v1 = -1;
  DeviceAttrFn attr = reinterpret_cast<DeviceAttrFn>(libcuda_symbol("cuDeviceGetAttribute"));
  if (attr != nullptr) {
    int r = attr(attr_v1, CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1, dev);
    if (r != 0) return CU_RESULT_BASE + r;
  }
  return 0;
}

// Copy chunk_bytes at `src` into each of `ntargets` device addresses dsts[t]
// (a peer's slot or this rank's own), then raise each non-zero flags[t] to
// `gen`.  counter: one word of this rank's workspace, 0 between launches.
int mmg_ring_peer_scatter(const void* src, long long chunk_bytes, int vec_bytes, int blocks,
                          const unsigned long long* dsts, const unsigned long long* flags,
                          int ntargets, void* counter, unsigned gen, void* stream) {
  if (ntargets < 1 || ntargets > MAX_RANKS || chunk_bytes <= 0 || blocks < 1 || gen == 0 ||
      vec_bytes <= 0 || chunk_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  Targets t;
  for (int i = 0; i < ntargets; ++i) {
    t.dst[i] = reinterpret_cast<unsigned char*>(dsts[i]);
    t.flag[i] = reinterpret_cast<unsigned*>(flags[i]);
  }
  unsigned* c = static_cast<unsigned*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return (int)launch_scatter<uint4>(src, chunk_bytes, blocks, t, ntargets, c, gen, s);
    case 8: return (int)launch_scatter<uint2>(src, chunk_bytes, blocks, t, ntargets, c, gen, s);
    case 4: return (int)launch_scatter<unsigned>(src, chunk_bytes, blocks, t, ntargets, c, gen, s);
    case 2: return (int)launch_scatter<unsigned short>(src, chunk_bytes, blocks, t, ntargets, c, gen, s);
    case 1: return (int)launch_scatter<unsigned char>(src, chunk_bytes, blocks, t, ntargets, c, gen, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Hold `stream` until each of the `count` flag words (device addresses in
// this rank's workspace) is >= gen.
int mmg_ring_wait(const unsigned long long* flags, int count, unsigned gen, void* stream) {
  StreamWaitFn wait = stream_wait_fn();
  if (wait == nullptr) return (int)cudaErrorNotSupported;
  for (int k = 0; k < count; ++k) {
    int r = wait(static_cast<cudaStream_t>(stream), flags[k], gen, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != 0) return CU_RESULT_BASE + r;
  }
  return 0;
}

// `slots` chunks of chunk_bytes, `stride` bytes apart in the workspace,
// into the contiguous output.
int mmg_ring_copy_out(void* out, const void* ws, long long chunk_bytes, long long stride, int slots,
                      void* stream) {
  return (int)cudaMemcpy2DAsync(out, (size_t)chunk_bytes, ws, (size_t)stride, (size_t)chunk_bytes,
                                (size_t)slots, cudaMemcpyDeviceToDevice,
                                static_cast<cudaStream_t>(stream));
}

// The host's way out of a wait that passed its deadline: raise `count` (at
// most MAX_RANKS) flag words (device addresses) to gen from a stream of its own,
// non-blocking (the held stream may be the legacy default stream, which a
// blocking stream would wait for), and wait for it.  The kernel was loaded
// with the workspace (mmg_ring_ipc_alloc).
int mmg_ring_release(const unsigned long long* flags, int count, unsigned gen) {
  if (count < 1 || count > MAX_RANKS) return (int)cudaErrorInvalidValue;
  FlagList list;
  for (int k = 0; k < count; ++k) list.flag[k] = reinterpret_cast<unsigned*>(flags[k]);
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return (int)err;
  release_kernel<<<1, 64, 0, s>>>(list, count, gen);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  return (int)err;
}

}  // extern "C"
