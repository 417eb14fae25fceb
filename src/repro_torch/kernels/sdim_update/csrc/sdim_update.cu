// sdim_update: fold a batch of event behaviors into rows of the (N, G, U, d)
// fp32 table store, in place:  store[slots[b], g, sig_g(e_bj)] += mask_bj * e_bj.
//
// Replaces the Pallas kernel sdim_update
// (src/repro/kernels/sdim_update/sdim_update.py:77, pallas_call at :115).
//
// Design. One block per batch row b, 256 threads. The Pallas version sorts
// the slots, carries a running total in VMEM and routes earlier duplicates
// to a trash row because its grid runs in order on one core. Here blocks run
// in parallel in no order, so each event's contribution is added straight
// into store[slots[b]] with a global atomicAdd: duplicate slots accumulate
// by themselves, and no sort, trash row or copy of the store exists. Events
// are hashed as in bse_encode (R staged in shared memory, one thread per
// (event, group), fp32 FMAs). An event whose mask is 0 adds nothing, so a
// zero-mask row aimed at slot 0 writes nothing at all. The sum order of the
// atomics changes from run to run.
//
// Bound on the H100 (full width d=128, m=48, tau=3): per touched row G*U*d*4
// = 64 KB read and written, plus E*d*4 bytes per event row read and
// 2*E*m*d FLOP of hashing. With E=16 events it is bound by the row traffic.
#include "sdim_common.cuh"

namespace sdim {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sdim_update_kernel(float* __restrict__ store, const int* __restrict__ slots,
                       const T* __restrict__ events, const float* __restrict__ mask,
                       const float* __restrict__ R, int E, int G, int U, int d, int m, int tau) {
  extern __shared__ float smem[];
  const int ld = padded(d);
  float* r_s = smem;
  float* x_s = r_s + (size_t)m * ld;
  float* w_s = x_s + (size_t)kTileRows * ld;
  int* sig_s = reinterpret_cast<int*>(w_s + kTileRows);

  const int b = blockIdx.x;
  float* row = store + (size_t)slots[b] * G * U * d;
  const T* x = events + (size_t)b * E * d;
  const float* w = mask + (size_t)b * E;

  load_r(r_s, R, m, d);
  for (int e0 = 0; e0 < E; e0 += kTileRows) {
    const int n = min(kTileRows, E - e0);
    __syncthreads();  // R staged, or the previous tile's adds done
    load_tile(x_s, x + (size_t)e0 * d, n, d);
    for (int i = threadIdx.x; i < kTileRows; i += blockDim.x) w_s[i] = i < n ? w[e0 + i] : 0.f;
    __syncthreads();
    tile_signatures(sig_s, x_s, r_s, n, G, tau, d);
    __syncthreads();
    for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
      const int g = i / d, k = i % d;
      float* col = row + (size_t)g * U * d + k;
      for (int r = 0; r < n; ++r) {
        const float wr = w_s[r];
        if (wr != 0.f) atomicAdd(col + (size_t)sig_s[r * G + g] * d, wr * x_s[r * ld + k]);
      }
    }
  }
}

template <typename T>
static cudaError_t launch(float* store, const int* slots, const void* events, const float* mask,
                          const float* R, int B, int E, int G, int U, int d, int m, int tau,
                          cudaStream_t stream) {
  const size_t smem = update_smem_bytes(G, d, m);
  cudaError_t err = cudaFuncSetAttribute(sdim_update_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sdim_update_kernel<T><<<B, kThreads, smem, stream>>>(
      store, slots, static_cast<const T*>(events), mask, R, E, G, U, d, m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// store (N, G*U, d) fp32 updated in place; slots (B,) int32 in [0, N);
// events (B, E, d) fp32|bf16; mask (B, E) fp32; R (m, d) fp32.
extern "C" int sdim_update(float* store, const int* slots, const void* events, int ev_dtype,
                           const float* mask, const float* R, int B, int E, int G, int U, int d,
                           int m, int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ev_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(store, slots, events, mask, R, B, E, G, U, d, m, tau, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(store, slots, events, mask, R, B, E, G, U, d, m, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}
