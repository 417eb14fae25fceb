// sdim_update for tau 5..10 (large_tau.cuh says why these paths exist): the
// entry point sdim_update (sdim_update.cu) launches it for tau > 4.
//
//   store[slots[b], g, sig_g(e_bj)] += mask_bj * e_bj        (in place)
//
// Replaces, for these tau, the Pallas kernel sdim_update
// (src/repro/kernels/sdim_update/sdim_update.py:77, pallas_call at :115).
// Bound on the H100 at Table 4's tau = 10 serving shape (d = 128, m = 40:
// G = 4, U = 1,024; 16 users of E = 16 events): an event reaches one row of
// d in each group, so a fold reads and writes at most E*G rows a batch row
// (32 KB here, against the 2 MiB of a whole fp32 store row) and reads the
// events, against 2*E*m*d FLOP of hashing: under a microsecond of bytes, so
// latency sets its time.
//
// Design (simple first). The grid is (B, G): CTA (b, g) works on group g of
// store row slots[b]. The tau <= 4 contracts hold (sdim_update.cu):
// - One owner per slot. A CTA exits at once if an earlier batch row has the
//   same slot; otherwise it lists the batch rows b' >= b with that slot in b
//   order, a window of kLargeTauThreads rows at a time (a ballot and a count
//   per warp), and folds them all. No two CTAs write one element; no atomics.
// - Hash. Eight lanes an event (bucket_of, the bits bse_encode's large-tau
//   path gives the same behavior), 32 events a round, for group g only; each
//   event's bucket, or -1 where its weight is 0, goes to the scratch sig
//   (B, E, G) int32 in device memory, which only this CTA writes at (its
//   owned rows, g) and reads back after a barrier (the window's events need
//   not fit shared memory, whatever E).
// - The cells reached. Thread t < U/32 ORs into its word the bits of the
//   buckets [32t, 32t + 32) that a weighted event of the window reached; a
//   warp prefix-sums the words' popcounts and lists the reached buckets in u
//   order in shared memory (at most min(U, events of the window)).
// - Fold. Eight lanes a reached cell (lane part: float4 columns part,
//   part + 8, ...; 32 cells a round): start from the stored cell, and for
//   each owned row in b order sum that row's events of the cell in e order
//   (fmaf(w, x, delta), as the tau <= 4 kernel), add the row's sum to the
//   running total, and write the cell back once. A cell no weighted event
//   reached is neither read nor written, so it keeps its bits (-0.0
//   included); a row whose mask is all zero reaches none.
// - A later window starts from the cells the earlier one wrote: the same
//   CTA, ordered by a barrier.
// Takes tau 5..10, d a multiple of 4 up to 128, events fp32 or bf16, E of
// any size; the store is updated in place.
#include "large_tau.cuh"

namespace sdim {

constexpr int kUpdateRows = kLargeTauThreads;                   // batch rows a window lists
constexpr int kUpdateCells = kLargeTauThreads / kEncodeHashLanes;  // cells folded a round

template <typename T>
__global__ void __launch_bounds__(kLargeTauThreads)
    update_large_tau_kernel(float* __restrict__ store, const int* __restrict__ slots,
                            const T* __restrict__ events, const float* __restrict__ mask,
                            const float* __restrict__ R, int* sig, int B, int E, int G, int U,
                            int d, int tau) {
  __shared__ int list_s[kUpdateRows];                    // the window's owned batch rows
  __shared__ int count_s[kLargeTauThreads / 32];
  __shared__ int reached_s[1 << kLargeTauMax];           // the reached buckets, in u order
  __shared__ int n_reached_s;
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int part = tid % kEncodeHashLanes, warp = tid / 32, lane = tid % 32;
  const int n_warps = blockDim.x / 32, words = U / 32;
  const int slot = __ldg(slots + b);
  bool earlier = false;
  for (int i = tid; i < b; i += blockDim.x) earlier |= __ldg(slots + i) == slot;
  if (__syncthreads_or(earlier)) return;  // an earlier batch row owns the slot

  const float* r = R + (size_t)g * tau * d;
  float* row = store + ((size_t)slot * G + g) * U * d;  // group g of the store row
  for (int p = b; p < B; p += kUpdateRows) {
    // the window's batch rows with this slot, in b order
    const int i = p + tid;
    const bool mine = i < B && __ldg(slots + i) == slot;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) count_s[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, count = 0;
    for (int v = 0; v < n_warps; ++v) {
      const int c = count_s[v];
      before += v < warp ? c : 0;
      count += c;
    }
    if (mine) list_s[before + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (count == 0) continue;  // the same for every thread

    // each owned event's bucket in group g, -1 where its weight is 0
    const int n = count * E;
    for (int base = 0; base < n; base += kUpdateCells) {  // the same trip count for all
      const int k = min(base + tid / kEncodeHashLanes, n - 1);
      const int bb = list_s[k / E], e = k % E;
      const bool live = base + tid / kEncodeHashLanes < n;
      const float w = live ? mask[(size_t)bb * E + e] : 0.f;
      const int u = bucket_of(events + ((size_t)bb * E + e) * d, r, d, tau, w != 0.f);
      if (live && part == 0) sig[((size_t)bb * E + e) * G + g] = w != 0.f ? u : -1;
    }
    __syncthreads();  // the window's buckets written and visible to the CTA

    // the reached buckets: a word of 32 a thread, then listed in u order
    unsigned word = 0;
    if (tid < words)
      for (int k = 0; k < n; ++k) {
        const int u = sig[((size_t)list_s[k / E] * E + k % E) * G + g];
        if (u >= 0 && u / 32 == tid) word |= 1u << (u % 32);
      }
    if (warp == 0) {  // words <= 32: all in warp 0
      const int c = __popc(word);
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int at = incl - c;
      for (unsigned w = word; w != 0u; w &= w - 1u) reached_s[at++] = lane * 32 + __ffs(w) - 1;
      if (lane == 31) n_reached_s = incl;
    }
    __syncthreads();

    // fold: eight lanes a reached cell, its events row by row in b order
    const int n_reached = n_reached_s;
    for (int base = 0; base < n_reached; base += kUpdateCells) {
      const int k = base + tid / kEncodeHashLanes;
      if (k >= n_reached) break;
      const int u = reached_s[k];
      float* cell = row + (size_t)u * d;
      float4 acc[kLargeTauCols];
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        acc[j] = k4 < nq ? load4(cell + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int s = 0; s < count; ++s) {
        const int bb = list_s[s];
        float4 delta[kLargeTauCols];
#pragma unroll
        for (int j = 0; j < kLargeTauCols; ++j) delta[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int e = 0; e < E; ++e) {
          if (sig[((size_t)bb * E + e) * G + g] != u) continue;
          const float w = mask[(size_t)bb * E + e];
          const T* x = events + ((size_t)bb * E + e) * d;
#pragma unroll
          for (int j = 0; j < kLargeTauCols; ++j) {
            const int k4 = part + j * kEncodeHashLanes;
            if (k4 < nq) delta[j] = axpy4(w, load4(x + 4 * k4), delta[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kLargeTauCols; ++j)  // the row's sum, to the running total
          acc[j] = make_float4(acc[j].x + delta[j].x, acc[j].y + delta[j].y,
                               acc[j].z + delta[j].z, acc[j].w + delta[j].w);
      }
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        if (k4 < nq) store4(cell + 4 * k4, acc[j]);
      }
    }
    __syncthreads();  // the cells written, list_s and reached_s free for the next window
  }
}

template <typename T>
static cudaError_t update_large_tau(float* store, const int* slots, const void* events,
                                    const float* mask, const float* R, int* sig, int B, int E,
                                    int G, int U, int d, int tau, cudaStream_t stream) {
  update_large_tau_kernel<T><<<dim3(B, G), kLargeTauThreads, 0, stream>>>(
      store, slots, static_cast<const T*>(events), mask, R, sig, B, E, G, U, d, tau);
  return cudaGetLastError();
}

cudaError_t launch_update_large_tau(float* store, const int* slots, const void* events,
                                   int ev_dtype, const float* mask, const float* R, int* sig,
                                   int B, int E, int G, int U, int d, int tau,
                                   cudaStream_t stream) {
  if (B < 0 || E < 0 || G <= 0 || G > 65535 || tau < kLargeTauMin || tau > kLargeTauMax ||
      U != (1 << tau) || d <= 0 || d % 4 != 0 || d > 128)
    return cudaErrorInvalidValue;
  if (B == 0 || E == 0) return cudaSuccess;
  if (sig == nullptr) return cudaErrorInvalidValue;
  switch (ev_dtype) {
    case kF32:
      return update_large_tau<float>(store, slots, events, mask, R, sig, B, E, G, U, d, tau,
                                     stream);
    case kBF16:
      return update_large_tau<__nv_bfloat16>(store, slots, events, mask, R, sig, B, E, G, U, d,
                                             tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
