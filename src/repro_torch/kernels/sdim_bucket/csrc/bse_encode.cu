// bse_encode: SimHash every behavior and bucket-sum it, per signature group,
// into the user's (G, U, d) table:  T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl.
//
// Replaces the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117, pallas_call at :137).
//
// Design. One block per (user, L-chunk), 256 threads. R (m, d) is staged in
// shared memory once per block; the behaviors stream through in tiles of
// kTileRows rows. Each (row, group) pair is hashed by one thread (fp32 FMAs,
// no tensor cores, so no TF32 rounding can flip a sign bit). The table
// (G*U, d) lives in shared memory for the whole chunk. The scatter
// (sdim_common.cuh: encode_rows, shared with bse_serve) gives each (group,
// column) cell set to one thread, so the table needs no shared-memory
// atomics and the rows of a chunk add in order. Every block
// adds its chunk into the zeroed output with global atomicAdd, so a user
// whose L is split over several blocks sums in an order that varies from
// run to run (a single chunk adds onto zero and is exact). Masked rows add
// nothing.
//
// Bound on the H100 (per user at full width d=128, m=48, tau=3, L=1024):
// reads L*d*4 + L*4 bytes, writes G*U*d*4 bytes (about 594 KB in all), and
// does 2*L*m*d = 12.6 MFLOP of fp32 hashing plus L*G*d adds for the scatter.
// Only valid rows need their d values read and hashed, so a ragged mask
// lowers both counts in proportion.
// At 3.35 TB/s and 67 TFLOP/s fp32 (non tensor core) the two are close; the
// hash loop on CUDA cores is what this simple version spends its time on.
#include "sdim_common.cuh"

namespace sdim {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bse_encode_kernel(const T* __restrict__ seq, const float* __restrict__ mask,
                      const float* __restrict__ R, float* __restrict__ out, int L,
                      int l_per_block, int G, int U, int d, int m, int tau) {
  extern __shared__ float smem[];
  const int GU = G * U, ld = padded(d);
  float* table_s = smem;
  float* r_s = table_s + (size_t)GU * d;
  float* x_s = r_s + (size_t)m * ld;
  float* w_s = x_s + (size_t)kTileRows * ld;
  int* sig_s = reinterpret_cast<int*>(w_s + kTileRows);

  const int b = blockIdx.x;
  const int l_begin = blockIdx.y * l_per_block;
  const int l_end = min(L, l_begin + l_per_block);
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;

  for (int i = threadIdx.x; i < GU * d; i += blockDim.x) table_s[i] = 0.f;
  load_r(r_s, R, m, d);

  encode_rows(table_s, r_s, x_s, w_s, sig_s, x, w, l_begin, l_end, G, U, d, tau);
  __syncthreads();

  float* o = out + (size_t)b * GU * d;
  for (int i = threadIdx.x; i < GU * d; i += blockDim.x) {
    const float v = table_s[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

template <typename T>
static cudaError_t launch(const void* seq, const float* mask, const float* R, float* out, int B,
                          int L, int l_per_block, int G, int U, int d, int m, int tau,
                          cudaStream_t stream) {
  const size_t smem = encode_smem_bytes(G, U, d, m);
  cudaError_t err = cudaFuncSetAttribute(bse_encode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (L + l_per_block - 1) / l_per_block);
  bse_encode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(seq), mask, R, out, L, l_per_block, G, U, d, m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d) fp32 -> out (B, G*U, d)
// fp32. The caller passes a zeroed out.
extern "C" int sdim_bse_encode(const void* seq, int seq_dtype, const float* mask, const float* R,
                               float* out, int B, int L, int l_per_block, int G, int U, int d,
                               int m, int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(seq, mask, R, out, B, L, l_per_block, G, U, d, m, tau, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(seq, mask, R, out, B, L, l_per_block, G, U, d, m, tau,
                                         s);
    default:
      return cudaErrorInvalidValue;
  }
}
