// bse_serve: inline SDIM serving in one launch. Each user's behaviors are
// SimHashed and bucket-summed into a (G, U, d) table, the table rows are
// l2-normalized, and the user's candidates are hashed and answered against
// it (paper Eq. 8/11/12):
//   out[b, c] = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl.
//
// Replaces the Pallas kernel bse_serve
// (src/repro/kernels/sdim_serve/sdim_serve.py:68, pallas_call at :91).
//
// Design. One block per user, 256 threads. The TPU kernel carried the table
// in VMEM scratch across a sequential grid over L tiles and turned to the
// query at the last step. Here a loop inside the block takes the place of
// that grid dimension: the (G*U, d) fp32 table (64 KB at full width) stays
// in shared memory for the block's whole life, all L rows stream through it
// in kTileRows tiles (sdim_common.cuh: encode_rows, the in-order scatter
// shared with bse_encode), then it is normalized in place (normalize_rows)
// and the candidates are answered kTileRows at a time (answer_candidates).
// The table never reaches device memory, so L is not split over blocks: a
// split would need the global atomics of bse_encode and a table in HBM.
// About 107 KB of dynamic shared memory at full width (d=128, m=48, tau=3).
// Candidates are read as fp32 (the TPU kernel casts them too). A user with
// every behavior masked has a zero table and gets zero output (the eps
// inside the sqrt keeps 0/0 out).
//
// Bound on the H100 (per user at full width, L=1024, C=128): reads the valid
// rows (L*d*4 bytes at most), the mask, the candidates and R, writes C*d*4
// bytes, and does 2*m*d FLOP of hashing plus G*d adds per valid row and per
// candidate: about 14 KFLOP each, so the hash on CUDA cores bounds it
// (operations). With one block per user a 16-request burst fills only 16 of
// the 132 SMs; spreading L over a thread-block cluster is later work.
#include "sdim_common.cuh"

namespace sdim {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bse_serve_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                     const float* __restrict__ mask, const float* __restrict__ R,
                     float* __restrict__ out, int L, int C, int G, int U, int d, int m, int tau) {
  extern __shared__ float smem[];
  const int GU = G * U, ld = padded(d);
  float* table_s = smem;
  float* r_s = table_s + (size_t)GU * d;
  float* x_s = r_s + (size_t)m * ld;
  float* w_s = x_s + (size_t)kTileRows * ld;
  int* sig_s = reinterpret_cast<int*>(w_s + kTileRows);

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < GU * d; i += blockDim.x) table_s[i] = 0.f;
  load_r(r_s, R, m, d);
  encode_rows(table_s, r_s, x_s, w_s, sig_s, seq + (size_t)b * L * d, mask + (size_t)b * L, 0, L,
              G, U, d, tau);
  __syncthreads();
  normalize_rows(table_s, GU, d);
  answer_candidates(table_s, r_s, x_s, sig_s, q + (size_t)b * C * d, out + (size_t)b * C * d,
                    1.f, C, G, U, d, tau);
}

template <typename T>
static cudaError_t launch(const float* q, const void* seq, const float* mask, const float* R,
                          float* out, int B, int L, int C, int G, int U, int d, int m, int tau,
                          cudaStream_t stream) {
  const size_t smem = encode_smem_bytes(G, U, d, m);
  cudaError_t err = cudaFuncSetAttribute(bse_serve_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bse_serve_kernel<T><<<B, kThreads, smem, stream>>>(q, static_cast<const T*>(seq), mask, R, out,
                                                      L, C, G, U, d, m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// q (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d) fp32
// -> out (B, C, d) fp32.
extern "C" int sdim_bse_serve(const float* q, const void* seq, int seq_dtype, const float* mask,
                              const float* R, float* out, int B, int L, int C, int G, int U, int d,
                              int m, int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(q, seq, mask, R, out, B, L, C, G, U, d, m, tau, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(q, seq, mask, R, out, B, L, C, G, U, d, m, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}
