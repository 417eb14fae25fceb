// target_attn_backward: the gradients of target attention in the candidates
// and the behaviors. With s_bcl = scale * (q_bc . seq_bl) where mask_bl > 0
// (else the constant -1e30), P = softmax_l(s) and out = P seq:
//   D_bc  = dout_bc . out_bc
//   dS    = P o (dout seq^T - D)        (0 where masked: those logits are constants)
//   dq    = scale * dS seq
//   dseq  = P^T dout + scale * dS^T q   (seq is both value and key)
// A user with every behavior masked attends uniformly (P = 1/L): its rows
// get sum_c dout_bc / L and its candidates no gradient.
//
// No TPU kernel corresponds to it: the Pallas kernel target_attention_flash
// (src/repro/kernels/target_attn/target_attn.py:59) has no backward, and
// the JAX package trains kind "target" through the XLA formulation
// (src/repro/core/target_attention.py), whose gradient XLA derives.
//
// Bound on the H100 (B=32, C=1, L=1024, d=128, the pointwise training
// step): it reads seq (16 MB), writes dseq (16 MB) and does ~8*C*L*d FLOP
// per user (the two logit products twice, the two weighted sums): bound by
// bytes (~10 us).
//
// Design (simple first), two launches on the stream:
// 1. stats, grid (C, B): one CTA per candidate; 32 row groups of 8 lanes
//    walk the rows (row group r takes rows r, r + 32, ..., loading 4 of
//    them at once, 2 at d > 128); lane `part` of a group holds the float4
//    columns part, part + 8, ... of the candidate, its dout and the row,
//    and lane_group_sum adds a dot product's partials. Pass one keeps an online max and denominator per row group
//    and merges the 32 in group order (M, DEN); D = dout . out. Pass two
//    recomputes each valid row's P and dS and sums dS * seq_l per row
//    group; the 32 partial sums are added in group order and dq written
//    once, with (M, DEN, D) for launch 2.
// 2. rows, grid (ceil(L/32), B): one CTA per 32-row tile of a user, a row
//    per row group; it loops over the candidates in order, recomputing P
//    and dS with the same dot products as launch 1, and writes its rows of
//    dseq once, in seq's type.
// No atomics: two launches give the same bits. Loops have the same trip
// count in every lane (shuffles take all 32). Any C and L >= 1 (the wrapper
// handles C = 0 and L = 0); d a multiple of 4 up to 256 (the wrapper
// checks). A row is nq = d / 4 float4 columns, lanes past nq hold zeros:
// fp32 rows and every candidate row are 16-byte multiples, bf16 behavior
// rows (72 bytes at d = 36) are read and written 8 bytes at a time, on
// the 8-byte boundaries any row of d % 4 == 0 starts on.
#include "tile_staging.cuh"

namespace sdim {

constexpr float kBwdMaskedLogit = -1e30f;  // target_attn.cu's masked logit
constexpr int kRowLanes = 8;               // lanes a row (or candidate) group
constexpr int kRowGroups = kThreads / kRowLanes;

// This lane's J float4 columns part, part + 8, ... of a row of d values
// (zeros past d, or for a row that does not exist).
template <int J, typename T>
__device__ __forceinline__ void load_cols(float4 (&v)[J], const T* row, int part, int nq,
                                          bool exists = true) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k4 = part + kRowLanes * j;
    v[j] = exists && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a . b over the row group's columns: this lane's partial in column order,
// then the group's butterfly; the same value in all 8 lanes.
template <int J>
__device__ __forceinline__ float group_dot(const float4 (&a)[J], const float4 (&b)[J]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) s = dot4(a[j], b[j], s);
  return lane_group_sum<kRowLanes>(s);
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ta_bwd_stats_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                        const T* __restrict__ seq, const float* __restrict__ mask,
                        const float* __restrict__ out, float* __restrict__ stats,
                        float* __restrict__ dq, int L, int C, int d, float scale) {
  constexpr int V = J <= 4 ? 4 : 2;  // rows a row group loads at once
  __shared__ float m_s[kRowGroups], den_s[kRowGroups];
  __shared__ float4 part_s[kRowGroups][8 * J];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int rg = tid / kRowLanes, part = tid % kRowLanes;
  const size_t bc = (size_t)b * C + c;
  float4 qv[J], dv[J], ov[J];
  load_cols<J>(qv, q + bc * d, part, nq);
  load_cols<J>(dv, dout + bc * d, part, nq);
  load_cols<J>(ov, out + bc * d, part, nq);
  const float Dc = group_dot<J>(dv, ov);  // dout . out
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;

  // pass one: the softmax's max and denominator, online per row group over
  // its rows in order, V rows' loads in flight at once
  float mx = kBwdMaskedLogit, den = 0.f;
  for (int l0 = 0; l0 < L; l0 += V * kRowGroups) {
    float4 xs[V][J];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      load_cols<J>(xs[v], x + (size_t)(l < L ? l : 0) * d, part, nq, l < L);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      const float s = group_dot<J>(qv, xs[v]);
      if (l < L) {
        const float a = w[l] > 0.f ? s * scale : kBwdMaskedLogit;
        const float mn = fmaxf(mx, a);
        den = den * expf(mx - mn) + expf(a - mn);
        mx = mn;
      }
    }
  }
  if (part == 0) {
    m_s[rg] = mx;
    den_s[rg] = den;
  }
  __syncthreads();
  float M = kBwdMaskedLogit;
  for (int r = 0; r < kRowGroups; ++r) M = fmaxf(M, m_s[r]);
  float DEN = 0.f;
  for (int r = 0; r < kRowGroups; ++r) DEN = fmaf(den_s[r], expf(m_s[r] - M), DEN);

  // pass two: dq = scale * sum over the valid rows of dS * seq_l
  float4 acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l0 = 0; l0 < L; l0 += V * kRowGroups) {
    float4 xs[V][J];
    bool valid[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      valid[v] = l < L && w[l] > 0.f;
      load_cols<J>(xs[v], x + (size_t)(l < L ? l : 0) * d, part, nq, valid[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float s = group_dot<J>(qv, xs[v]), dp = group_dot<J>(dv, xs[v]);
      const float ds = valid[v] ? expf(s * scale - M) / DEN * (dp - Dc) : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = axpy4(ds, xs[v][j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) part_s[rg][part + kRowLanes * j] = acc[j];
  __syncthreads();
  for (int k4 = tid; k4 < nq; k4 += blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < kRowGroups; ++r) {
      const float4 p = part_s[r][k4];
      a = make_float4(a.x + p.x, a.y + p.y, a.z + p.z, a.w + p.w);
    }
    store4(dq + bc * d + 4 * k4, scale4(a, scale));
  }
  if (tid == 0) {
    stats[4 * bc] = M;
    stats[4 * bc + 1] = DEN;
    stats[4 * bc + 2] = Dc;
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ta_bwd_rows_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                       const T* __restrict__ seq, const float* __restrict__ mask,
                       const float* __restrict__ stats, T* __restrict__ dseq, int L, int C, int d,
                       float scale) {
  const int b = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int rg = tid / kRowLanes, part = tid % kRowLanes;
  const int l = blockIdx.x * kRowGroups + rg;
  const bool in = l < L;
  const bool valid = in && mask[(size_t)b * L + l] > 0.f;
  const size_t row = (size_t)b * L + (in ? l : 0);
  float4 xv[J], qv[J], dv[J], acc[J];
  load_cols<J>(xv, seq + row * d, part, nq, in);
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    load_cols<J>(qv, q + bc * d, part, nq);
    load_cols<J>(dv, dout + bc * d, part, nq);
    const float M = stats[4 * bc], DEN = stats[4 * bc + 1], Dc = stats[4 * bc + 2];
    const float s = group_dot<J>(qv, xv), dp = group_dot<J>(dv, xv);
    const float p = expf((valid ? s * scale : kBwdMaskedLogit) - M) / DEN;
    const float k = valid ? scale * (p * (dp - Dc)) : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = axpy4(k, qv[j], axpy4(p, dv[j], acc[j]));
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k4 = part + kRowLanes * j;
      if (k4 < nq) store4(dseq + row * d + 4 * k4, acc[j]);
    }
  }
}

template <typename T, int J>
static cudaError_t launch_ta_backward(const float* dout, const float* q, const void* seq,
                                      const float* mask, const float* out, float* stats,
                                      float* dq, void* dseq, int B, int L, int C, int d,
                                      float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || C <= 0) return cudaErrorInvalidValue;
  ta_bwd_stats_kernel<T, J><<<dim3(C, B), kThreads, 0, stream>>>(
      dout, q, static_cast<const T*>(seq), mask, out, stats, dq, L, C, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ta_bwd_rows_kernel<T, J><<<dim3((L + kRowGroups - 1) / kRowGroups, B), kThreads, 0, stream>>>(
      dout, q, static_cast<const T*>(seq), mask, stats, static_cast<T*>(dseq), L, C, d, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_ta_backward_d(const float* dout, const float* q, const void* seq,
                                        const float* mask, const float* out, float* stats,
                                        float* dq, void* dseq, int B, int L, int C, int d,
                                        float scale, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_ta_backward<T, 1>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                    stream);
  if (d <= 64)
    return launch_ta_backward<T, 2>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                    stream);
  if (d <= 128)
    return launch_ta_backward<T, 4>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                    stream);
  if (d <= 256)
    return launch_ta_backward<T, 8>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                    stream);
  return cudaErrorInvalidValue;
}

}  // namespace sdim

// dout, q, out (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32 ->
// dq (B, C, d) fp32 and dseq (B, L, d) in seq's type, every element written;
// stats (B, C, 4) fp32 is scratch (M, DEN, D per candidate). scale is the
// forward's logit scale (1/sqrt(d) rounded to fp32).
extern "C" int sdim_target_attention_backward(const float* dout, const float* q, const void* seq,
                                              int seq_dtype, const float* mask, const float* out,
                                              float* stats, float* dq, void* dseq, int B, int L,
                                              int C, int d, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_ta_backward_d<float>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C,
                                               d, scale, s);
    case sdim::kBF16:
      return sdim::launch_ta_backward_d<__nv_bfloat16>(dout, q, seq, mask, out, stats, dq, dseq,
                                                       B, L, C, d, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
