// bse_encode_backward: the gradient of bse_encode in the behaviors.
// Signatures are comparisons and carry no gradient, so the gradient of
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl
// is a gather:
//   dseq[b, l] = mask_bl * sum_g dT[b, g, sig_g(s_bl)]     (g in order 0..G-1).
//
// No TPU kernel corresponds to it: the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117) has no backward, and
// the JAX package trains through the XLA formulation of encode
// (src/repro/core/engine.py:123-127), whose gradient XLA derives.
//
// Bound on the H100 (per user at full width d=128, m=48, tau=3, L=1024):
// reads the valid rows (L*d*4 bytes at most), the mask, R and the user's
// G*U*d*4 = 64 KB of dT, writes L*d*4 bytes of gradient, and does 2*m*d
// FLOP of hashing plus G*d adds per valid row (~14 KFLOP): about equally
// bound by bytes and fp32 operations (~10 us for 32 users).
//
// Design (simple first). The grid is (S, B): CTA (j, b) owns user b's rows
// [j*L/S, (j+1)*L/S), so every output element is written once, with no
// atomics. It copies the user's dT (G*U rows) and R into shared memory,
// then each of its 8 warps takes four rows at a time, one per 8-lane group:
// - group h recomputes its row's m projections exactly as bse_encode.cu
//   does (IEEE fp32, no TF32): lane part sums the float4 columns part,
//   part + 8, ... with dot4 in column order, lane_group_sum<kEncodeHashLanes>
//   adds the partials, bit = [r . x >= 0], packed little-endian inside each
//   group; a ballot per projection gives the four rows' bits at once, and
//   four rows' loads are in flight together;
// - a row whose mask is 0 is not read and gets a zero gradient; four rows
//   that are all masked are not hashed;
// - then, row by row, lane k sums float4 column k of the row's G gathered
//   rows of dT in group order, times the mask, and writes it in seq's type
//   (bf16 rounded to nearest even).
// The wrapper picks S so that the B*S CTAs fill the card in one wave at two
// CTAs an SM. d a multiple of 4 up to 128 (at d = 36 lane part 0 of a
// group holds float4 columns 0 and 8, the others one), tau 1..4, and the user's table
// and R within shared memory (the wrapper checks).
#include "tile_staging.cuh"

namespace sdim {

constexpr int kBwdWarps = 8, kBwdThreads = 32 * kBwdWarps;

struct EncodeBwdLayout {
  size_t t, r, bits, total;
};

// Dynamic shared memory: the user's dT (G*U dense rows), R (rows padded to
// staged_ld, as bse_encode stages it) and each warp's signature bits, a
// byte a projection (bit h: the warp's row h).
__host__ __device__ inline EncodeBwdLayout encode_bwd_layout(int G, int U, int d, int m) {
  EncodeBwdLayout s;
  size_t o = 0;
  s.t = o;
  o += align16(sizeof(float) * G * U * d);
  s.r = o;
  o += align16(sizeof(float) * m * staged_ld<float>(d));
  s.bits = o;
  o += align16(kBwdWarps * m);
  s.total = o;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    bse_encode_backward_kernel(const float* __restrict__ dT, const T* __restrict__ seq,
                               const float* __restrict__ mask, const float* __restrict__ R,
                               T* __restrict__ dseq, int L, int G, int U, int d, int m, int tau) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const EncodeBwdLayout lay = encode_bwd_layout(G, U, d, m);
  float* t_s = reinterpret_cast<float*>(smem + lay.t);  // (G*U, d)
  float* r_s = reinterpret_cast<float*>(smem + lay.r);  // (m, ldr)
  const int S = gridDim.x, b = blockIdx.y;
  const int l_lo = (int)((long long)blockIdx.x * L / S);
  const int l_hi = (int)((long long)(blockIdx.x + 1) * L / S);
  const int nq = d / 4, ldr = staged_ld<float>(d), tid = threadIdx.x;

  const float4* t_src = reinterpret_cast<const float4*>(dT + (size_t)b * G * U * d);
#pragma unroll 4
  for (int i = tid; i < G * U * nq; i += blockDim.x)
    reinterpret_cast<float4*>(t_s)[i] = __ldg(t_src + i);
#pragma unroll 4
  for (int i = tid; i < m * nq; i += blockDim.x) {
    const int j = i / nq, k4 = i % nq;
    *reinterpret_cast<float4*>(r_s + j * ldr + 4 * k4) =
        __ldg(reinterpret_cast<const float4*>(R + (size_t)j * d) + k4);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, n_rows = l_hi - l_lo;
  const int h = lane / kEncodeHashLanes, part = lane % kEncodeHashLanes;
  unsigned char* bits = smem + lay.bits + warp * m;
  for (int r0 = 4 * warp; r0 < n_rows; r0 += 4 * kBwdWarps) {  // warp-uniform
    const bool in = r0 + h < n_rows;
    const size_t row = (size_t)b * L + l_lo + (in ? r0 + h : 0);  // group h's row
    const float w = in ? mask[row] : 0.f;
    if (rows_of(__ballot_sync(0xffffffffu, w != 0.f)) != 0u) {  // a row to hash
      float4 xv[4];  // this lane's columns part, part + 8, part + 16, part + 24 (d <= 128)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k4 = part + kEncodeHashLanes * i;
        xv[i] = w != 0.f && k4 < nq ? load4(seq + row * d + 4 * k4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k4 = part + kEncodeHashLanes * i;
          if (k4 < nq) a = dot4(load4(r_s + j * ldr + 4 * k4), xv[i], a);
        }
        a = lane_group_sum<kEncodeHashLanes>(a);
        const unsigned ballot = __ballot_sync(0xffffffffu, a >= 0.f);
        if (lane == 0) bits[j] = static_cast<unsigned char>(rows_of(ballot));
      }
    }
    __syncwarp();  // the rows' bits written
    for (int hh = 0; hh < 4 && r0 + hh < n_rows; ++hh) {  // warp-uniform
      const float wr = __shfl_sync(0xffffffffu, w, hh * kEncodeHashLanes);
      T* o = dseq + ((size_t)b * L + l_lo + r0 + hh) * d;
      if (lane < nq) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (wr != 0.f) {  // a masked row has no gradient
          for (int g = 0; g < G; ++g) {
            int u = 0;
            for (int t = 0; t < tau; ++t) u |= ((bits[g * tau + t] >> hh) & 1) << t;
            const float4 v = load4(t_s + (size_t)(g * U + u) * d + 4 * lane);
            s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
          }
          s = make_float4(wr * s.x, wr * s.y, wr * s.z, wr * s.w);
        }
        store4(o + 4 * lane, s);
      }
    }
    __syncwarp();  // the bits read before the next rows write theirs
  }
}

template <typename T>
static cudaError_t launch_backward(const float* dT, const void* seq, const float* mask,
                                   const float* R, void* dseq, int B, int L, int G, int U, int d,
                                   int m, int tau, int S, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || d > 128 || tau < 1 || tau > 4 || S < 1) return cudaErrorInvalidValue;
  const size_t smem = encode_bwd_layout(G, U, d, m).total;
  const void* fn = reinterpret_cast<const void*>(bse_encode_backward_kernel<T>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  bse_encode_backward_kernel<T><<<dim3(S, B), kBwdThreads, smem, stream>>>(
      dT, static_cast<const T*>(seq), mask, R, static_cast<T*>(dseq), L, G, U, d, m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// dT (B, G*U, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d)
// fp32 -> dseq (B, L, d) in seq's type, every element written; S row chunks
// per user.
extern "C" int sdim_bse_encode_backward(const float* dT, const void* seq, int seq_dtype,
                                        const float* mask, const float* R, void* dseq, int B,
                                        int L, int G, int U, int d, int m, int tau, int S,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_backward<float>(dT, seq, mask, R, dseq, B, L, G, U, d, m, tau, S, s);
    case sdim::kBF16:
      return sdim::launch_backward<__nv_bfloat16>(dT, seq, mask, R, dseq, B, L, G, U, d, m,
                                                  tau, S, s);
    default:
      return cudaErrorInvalidValue;
  }
}
