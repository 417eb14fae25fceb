// Code shared by the cluster kernels (target_attn, bse_serve, the backward
// kernels): tiles of rows staged into shared memory with asynchronous copies
// (cp.async, so the next tile lands while the current one is computed), bulk
// copies on mbarriers (multicast to a cluster's CTAs too),
// phase clocks, and on the host the launch of a grid of thread-block
// clusters. The float4 reads and fp32 FMA steps are in sdim_common.cuh.
//
// Staged rows are d elements plus 16 bytes: where a row is a whole number of
// 16-byte pieces every staged row stays 16-byte aligned for cp.async and
// float4 reads, and consecutive rows start 4 banks apart, so eight threads
// that read one float4 of eight different rows hit 32 banks. A row of
// 8-byte multiples only (bf16 at d % 8 == 4, e.g. d = 36: 72 bytes) is
// copied in 8-byte pieces, and its staged rows are 8-byte aligned, which
// the bf16 load4 needs. The copies need d * sizeof(T) to be a multiple of 8
// and 16-byte aligned sources (the wrappers check both).
//
// Numerics: plain IEEE fp32, as sdim_common.cuh.
#pragma once

#include <mutex>

#include "sdim_common.cuh"

namespace sdim {

// Row stride, in elements of T, of a staged (rows, d) tile.
template <typename T>
__host__ __device__ constexpr int staged_ld(int d) {
  return d + 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Copy 16 bytes from global to shared memory asynchronously; with
// src_bytes < 16 only that many are read and the rest of the 16 are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The same for 8 bytes (cp.async.ca: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying n <= rows rows of a (n, d) array x into the staged tile dst
// of `rows` rows; rows n..rows-1 are filled with zeros. The caller commits.
template <typename T>
__device__ __forceinline__ void stage_rows_async(T* dst, const T* __restrict__ x, int n, int rows,
                                                 int d) {
  if ((d * sizeof(T)) % 16 != 0) {  // rows of whole 8-byte pieces only
    constexpr int kPer8 = 8 / sizeof(T);
    const int per_row = d / kPer8, ld = staged_ld<T>(d);
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = i % per_row;
      const T* src = r < n ? x + (size_t)r * d + c * kPer8 : x;
      cp_async8(dst + (size_t)r * ld + c * kPer8, src, r < n ? 8 : 0);
    }
    return;
  }
  constexpr int kPer16 = 16 / sizeof(T);
  const int per_row = d / kPer16, ld = staged_ld<T>(d);
  if (blockDim.x % per_row == 0) {  // each thread keeps one 16-byte column: no division per copy
    const int c = threadIdx.x % per_row, step = blockDim.x / per_row;
    for (int r = threadIdx.x / per_row; r < rows; r += step) {
      const T* src = r < n ? x + (size_t)r * d + c * kPer16 : x;
      cp_async16(dst + (size_t)r * ld + c * kPer16, src, r < n ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i % per_row;
    const T* src = r < n ? x + (size_t)r * d + c * kPer16 : x;
    cp_async16(dst + (size_t)r * ld + c * kPer16, src, r < n ? 16 : 0);
  }
}

// Bulk copies (the copy engine moves a whole block; no thread issues
// per-16-byte copies) completing on an mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Make `bar` count `arrivals` arrivals per phase; run by one thread before
// any use, followed by a barrier of the threads that use it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n\t"
               "fence.mbarrier_init.release.cluster;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// One thread: arrive on `bar` and make its phase wait for `bytes` more
// bytes of bulk copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory to shared memory, counted on `bar` (see mbar_expect).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n\t"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: bulk_copy of `bytes` to the same offset `dst` of the shared
// memory of each CTA of the cluster whose bit is set in `cta_mask`, counted
// on the mbarrier at `bar`'s offset in each of them (each expects the bytes
// it receives, and its barrier was initialized before: a cluster barrier
// between the two).
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, unsigned bytes,
                                                    unsigned long long* bar,
                                                    unsigned short cta_mask) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n\t"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(cta_mask)
      : "memory");
}

// One thread: bulk_copy of a single block, arriving on `bar` for it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Phase clocks (phase_clocks.py at the repository root)
// ---------------------------------------------------------------------------
// Built with -DSDIM_PHASE_CLOCKS, every thread adds the SM cycles since its
// previous mark to slot k of a register array (PHASE_MARK(k), k <
// kPhaseSlots, k a constant), and thread 0 of each CTA writes the slots
// and the %globaltimer (ns) of PHASE_BEGIN and PHASE_END to its CTA's row
// of phase_cycles at PHASE_END (PHASE_END_AT(first): at row first + the
// CTA's index, for a second kernel of one translation unit), so a mark
// costs no memory access; a C entry point made by PHASE_READER copies the
// rows out. Built without it (the port's library), the marks compile to
// nothing.
#ifdef SDIM_PHASE_CLOCKS
constexpr int kPhaseSlots = 7, kPhaseCTAs = 8192;
static __device__ unsigned long long phase_cycles[kPhaseCTAs][kPhaseSlots + 2];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void phase_write(const long long* acc, unsigned long long t0,
                                            int first = 0) {
  const int cta = first + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x != 0 || cta >= kPhaseCTAs) return;
  for (int k = 0; k < kPhaseSlots; ++k) phase_cycles[cta][k] = acc[k];
  phase_cycles[cta][kPhaseSlots] = t0;
  phase_cycles[cta][kPhaseSlots + 1] = global_ns();
}

#define PHASE_BEGIN()                                   \
  const unsigned long long phase_t0 = global_ns();      \
  long long phase_acc[kPhaseSlots] = {};                \
  long long phase_t = clock64()
#define PHASE_MARK(k)                                   \
  do {                                                  \
    const long long phase_now = clock64();              \
    phase_acc[k] += phase_now - phase_t;                \
    phase_t = phase_now;                                \
  } while (0)
#define PHASE_END() phase_write(phase_acc, phase_t0)
#define PHASE_END_AT(first) phase_write(phase_acc, phase_t0, first)
#define PHASE_READER(name)                                                          \
  extern "C" int name(void* host, int bytes) {                                      \
    return cudaMemcpyFromSymbol(host, sdim::phase_cycles,                           \
                                bytes < (int)sizeof(sdim::phase_cycles)             \
                                    ? bytes : (int)sizeof(sdim::phase_cycles));     \
  }
#else
#define PHASE_BEGIN()
#define PHASE_MARK(k)
#define PHASE_END()
#define PHASE_END_AT(first)
#define PHASE_READER(name)
#endif

// ---------------------------------------------------------------------------
// Host: cluster launches
// ---------------------------------------------------------------------------
// Let `fn` take `smem` bytes of dynamic shared memory on the current device:
// cudaFuncSetAttribute once per (device, kernel) and size grown, not at
// every launch (a launch timed with events pays for every host call).
inline cudaError_t allow_smem(const void* fn, size_t smem) {
  struct Allowed {
    int device;
    const void* fn;
    size_t smem;
  };
  static std::mutex mu;
  static Allowed cache[64];
  static int n_cached = 0;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n_cached && !(cache[i].device == device && cache[i].fn == fn)) ++i;
  if (i < n_cached && cache[i].smem >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (i < n_cached) cache[i].smem = smem;
  else if (n_cached < 64) cache[n_cached++] = Allowed{device, fn, smem};
  return cudaSuccess;
}

// How many clusters of s CTAs of `fn` (`threads` threads, `smem` bytes of
// dynamic shared memory) the current device holds at once; asked once per
// (device, kernel, smem, s) and remembered.
inline int max_active_clusters(const void* fn, size_t smem, int s, int threads = kThreads) {
  struct Fit {
    int device;
    const void* fn;
    size_t smem;
    int s, clusters;
  };
  static std::mutex mu;
  static Fit cache[64];
  static int n_cached = 0;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    const Fit& f = cache[i];
    if (f.device == device && f.fn == fn && f.smem == smem && f.s == s) return f.clusters;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a query the device refuses is no launch error
    clusters = 0;
  }
  if (n_cached < 64) cache[n_cached++] = Fit{device, fn, smem, s, clusters};
  return clusters;
}

// How many CTAs of `fn` (`threads` threads, `smem` bytes of dynamic shared
// memory) one SM of the current device holds at once: 0 where `smem`
// exceeds a CTA's opt-in maximum; asked once per (device, kernel, smem,
// threads) and remembered.
inline int max_active_ctas(const void* fn, size_t smem, int threads) {
  struct Fit {
    int device;
    const void* fn;
    size_t smem;
    int threads, ctas;
  };
  static std::mutex mu;
  static Fit cache[64];
  static int n_cached = 0;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    const Fit& f = cache[i];
    if (f.device == device && f.fn == fn && f.smem == smem && f.threads == threads)
      return f.ctas;
  }
  int ctas = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      smem > static_cast<size_t>(optin) || allow_smem(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, smem) != cudaSuccess) {
    cudaGetLastError();  // a query the device refuses is no launch error
    ctas = 0;
  }
  if (n_cached < 64) cache[n_cached++] = Fit{device, fn, smem, threads, ctas};
  return ctas;
}

// Launch `kernel` with kThreads threads and `smem` bytes of dynamic shared
// memory on a (s * gx, gy) grid in clusters of s CTAs along x, and return
// the launch's error. s is the largest of s_max, s_max - 1, ..., s_min for
// which the device holds all gx * gy clusters at once (one wave), else
// s_max; the kernel reads s as cluster.num_blocks().
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int s_max, int s_min, int gx, int gy,
                            size_t smem, cudaStream_t stream, Args... args) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  int s = s_max;
  for (int c = s_max; c >= s_min; --c) {
    if ((long long)gx * gy <= max_active_clusters(fn, smem, c)) {
      s = c;
      break;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s * gx, gy);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sdim
