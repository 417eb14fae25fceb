// target_attn: target attention of C candidates against one user's whole
// behavior sequence (DIN, paper §3.2; the function SDIM approximates):
//   out[b, c] = sum_l softmax_l(s_bcl) * seq_bl,
//   s_bcl = (q_bc . seq_bl) * scale   where mask_bl > 0, else -1e30.
// A user with every behavior masked attends uniformly over all L rows, as
// the softmax of equal logits does.
//
// Replaces the Pallas kernel target_attention_flash
// (src/repro/kernels/target_attn/target_attn.py:59, pallas_call at :74).
//
// Design. One block per (user, tile of kTileRows candidates), 256 threads.
// The TPU kernel carried the running max, denominator and (TC, d)
// accumulator in VMEM scratch across a sequential grid over L tiles; here a
// loop inside the block streams L through shared memory kTileRows rows at a
// time and keeps those three in shared memory (online softmax, fp32):
//   m' = max(m, max_l s) ; alpha = e^(m - m') ; p_l = e^(s_l - m')
//   den = den * alpha + sum_l p_l ; acc = acc * alpha + sum_l p_l * seq_l
// and the output is acc / (den + 1e-30), as the TPU kernel. Logits are fp32
// FMAs on CUDA cores (no tensor cores, so no TF32); seq is read in its
// storage type and widened to fp32 on load. Rows past L in the last tile are
// never scored, so they stay out of a fully masked user's uniform mean;
// candidates past C in the last tile are neither scored nor written. Any C
// and L, 0 included, are taken (the TPU kernel asserts whole tiles).
//
// Bound on the H100 (B=16, C=128, L=1024, d=128): 4*B*C*L*d = 1.07 GFLOP of
// fp32 (the two products) against about 10.5 MB of input: bound by
// operations, 0.016 ms at 67 TFLOP/s. This simple version does every
// product as a serial fp32 dot per thread out of shared memory.
#include "sdim_common.cuh"

namespace sdim {

constexpr float kMaskedLogit = -1e30f;
static_assert(kTileRows == 32, "one warp lane per behavior row of a tile");

inline size_t target_attn_smem_bytes(int d) {
  const size_t t = kTileRows;
  return sizeof(float) * (2 * t * padded(d) + t * d + t * t + 4 * t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    target_attn_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                       const float* __restrict__ mask, float* __restrict__ out, int L, int C,
                       int d, float scale) {
  extern __shared__ float smem[];
  const int ld = padded(d);
  float* q_s = smem;                         // (TC, ld) candidates
  float* x_s = q_s + kTileRows * ld;         // (TL, ld) behavior tile
  float* acc_s = x_s + kTileRows * ld;       // (TC, d) running weighted sum
  float* p_s = acc_s + kTileRows * d;        // (TC, TL) logits, then weights
  float* w_s = p_s + kTileRows * kTileRows;  // (TL) mask of the tile
  float* m_s = w_s + kTileRows;              // (TC) running max
  float* den_s = m_s + kTileRows;            // (TC) running denominator
  float* a_s = den_s + kTileRows;            // (TC) this tile's rescale factor

  const int b = blockIdx.x, c0 = blockIdx.y * kTileRows;
  const int nc = min(kTileRows, C - c0);
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;

  load_tile(q_s, q + ((size_t)b * C + c0) * d, nc, d);
  for (int i = threadIdx.x; i < kTileRows * d; i += blockDim.x) acc_s[i] = 0.f;
  for (int i = threadIdx.x; i < kTileRows; i += blockDim.x) {
    m_s[i] = kMaskedLogit;
    den_s[i] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += kTileRows) {
    const int n = min(kTileRows, L - l0);
    __syncthreads();  // state initialized, or the previous tile's reads done
    load_tile(x_s, x + (size_t)l0 * d, n, d);
    for (int i = threadIdx.x; i < kTileRows; i += blockDim.x) w_s[i] = i < n ? w[l0 + i] : 0.f;
    __syncthreads();
    for (int i = threadIdx.x; i < nc * n; i += blockDim.x) {
      const int c = i / n, r = i % n;
      const float* qc = q_s + c * ld;
      const float* xr = x_s + r * ld;
      float s = 0.f;
      for (int k = 0; k < d; ++k) s = fmaf(qc[k], xr[k], s);
      p_s[c * kTileRows + r] = w_s[r] > 0.f ? s * scale : kMaskedLogit;
    }
    __syncthreads();
    // one warp per candidate, one lane per row of the tile
    for (int c = warp; c < nc; c += n_warps) {
      float* p = p_s + c * kTileRows;
      const float m_prev = m_s[c];
      const float s = lane < n ? p[lane] : kMaskedLogit;
      float mx = s;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      const float e = lane < n ? expf(s - m_new) : 0.f;
      p[lane] = e;
      float sum = e;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[c] = alpha;
        den_s[c] = den_s[c] * alpha + sum;
        m_s[c] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * d; i += blockDim.x) {
      const int c = i / d, k = i % d;
      const float* p = p_s + c * kTileRows;
      float s = 0.f;
      for (int r = 0; r < n; ++r) s = fmaf(p[r], x_s[r * ld + k], s);
      acc_s[i] = acc_s[i] * a_s[c] + s;
    }
  }
  __syncthreads();
  float* o = out + ((size_t)b * C + c0) * d;
  for (int i = threadIdx.x; i < nc * d; i += blockDim.x) o[i] = acc_s[i] / (den_s[i / d] + 1e-30f);
}

template <typename T>
static cudaError_t launch(const float* q, const void* seq, const float* mask, float* out, int B,
                          int L, int C, int d, float scale, cudaStream_t stream) {
  const size_t smem = target_attn_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(target_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + kTileRows - 1) / kTileRows);
  target_attn_kernel<T><<<grid, kThreads, smem, stream>>>(q, static_cast<const T*>(seq), mask,
                                                          out, L, C, d, scale);
  return cudaGetLastError();
}

}  // namespace sdim

// q (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32 -> out
// (B, C, d) fp32; scale is the logit scale (1/sqrt(d) rounded to fp32).
extern "C" int sdim_target_attention(const float* q, const void* seq, int seq_dtype,
                                     const float* mask, float* out, int B, int L, int C, int d,
                                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(q, seq, mask, out, B, L, C, d, scale, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(q, seq, mask, out, B, L, C, d, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
