// sdim_update: fold a batch of event behaviors into rows of the (N, G, U, d)
// fp32 table store, in place:  store[slots[b], g, sig_g(e_bj)] += mask_bj * e_bj.
//
// Replaces the Pallas kernel sdim_update
// (src/repro/kernels/sdim_update/sdim_update.py:77, pallas_call at :115),
// which sorts the batch by slot, carries a running total of each slot in
// VMEM across its sequential grid (acc = store[slot]; acc += delta_b for
// each batch row b of the slot, in b order) and routes all but the last
// duplicate to a trash row.
//
// Bound on the H100 (full width d=128, m=48, tau=3, E=16): per touched
// row G*U*d*4 = 64 KB read and written, plus E*d*4 bytes of events per
// batch row and 2*E*m*d FLOP of hashing: bound by the row traffic (~0.5 us
// for a 32-row burst). What sets the time is latency: the slot, the row,
// R and the events must arrive before anything can be summed, and a slot
// that many batch rows share is folded by one owner, row after row
// (phase_clocks.py).
//
// Design. The grid is (S, B): CTA (j, b) owns signature groups
// [j*G/S, (j+1)*G/S) of store row slots[b] (uneven where S does not divide
// G); the wrapper picks S so that the B*S CTAs fill one wave at two CTAs
// an SM.
// - One owner per slot. A CTA exits at once if an earlier batch row has
//   the same slot; otherwise it lists every batch row b' >= b with that
//   slot, in b order (a window of kThreads rows at a time), and folds
//   them all: the Pallas kernel's order, with no sort, no atomics and no
//   second launch. No two CTAs write one element, and two launches agree
//   bit for bit.
// - Units of rows. The owned rows are folded a unit at a time: up to
//   kEv / E whole rows (E <= kEv), or one batch of kEv of a row's events
//   (E > kEv). Units run in a pipeline of kBufs event buffers: between two
//   barriers the CTA sums unit v and hashes unit v + 1 while unit v + 2 is
//   in flight, so a slot with many rows costs one barrier a unit.
// - Everything in flight at once. One thread puts on mbarriers the bulk
//   copies of the R rows of the CTA's groups and of row b's events (one
//   contiguous copy a row) at the start, and of the CTA's slice of the
//   store row (contiguous, ng*U*d*4 bytes) as soon as the slot is known;
//   the slot scan runs while they travel. A bulk copy moves whole 16-byte
//   pieces from 16-byte aligned addresses, so where an event row is an
//   8-byte multiple only (bf16 at d % 8 == 4, e.g. d = 36: 72 bytes, rows
//   starting at any 8-byte boundary) warp 0 copies a unit's rows itself
//   with 8-byte loads and stores, and lane 0 arrives on the buffer's
//   mbarrier after a warp barrier: the same buffers and waits, with no
//   copy in flight. The mask is read with plain
//   loads (a row of E floats need not be 16-byte aligned) when its unit is
//   staged.
// - Hash only the CTA's groups: eight lanes share two events, each over
//   every eighth float4 column, for the TAU projections of one group, and
//   a butterfly over the eight lanes adds the partial sums (IEEE fp32
//   FMAs, bit = [r . x >= 0], little-endian in the group), each event's
//   bucket id written once to shared memory. Before the sums each warp
//   turns the ids into a 32-bit mask of events for each of its cells, one
//   ballot a cell (lane e tests event e).
// - Sum in registers, write once. A thread holds up to kItems (cell,
//   float4 column) sums. For each owned batch row it sums the row's events
//   of each of its cells in e order with their weights (one event of every
//   item a step, so the items' loads overlap), then adds that bucket sum
//   to the running total, which starts from the staged store slice (first
//   awaited there, so the slice's copy overlaps the first hash). At the
//   end it writes, with 16-byte stores, only the cells that some event
//   with a nonzero weight reached: a row whose mask is all zero writes
//   nothing, and an untouched cell keeps its bits (-0.0 included).
// Takes tau 1..4, d a multiple of 4 up to 128 and ceil(G/S) * 2^tau <=
// kItems * (kThreads / (d/4)) cells a CTA, events fp32 or bf16 and 16-byte
// aligned operands (the wrapper checks); E of any size. tau 5..10 (32..1,024
// buckets a group) launch large_tau.cuh's path (sdim_update_large_tau.cu:
// a CTA a (batch row, group) reads and writes only the cells its events
// reach), and so does d > 128 at any tau (its wide rows: at d = 256 a CTA
// here holds kItems * kThreads / 64 = 8 cells, fewer than one group's 16
// at tau = 4; the list path holds no cell in registers across events).
#include "tile_staging.cuh"
#include "large_tau.cuh"

namespace sdim {

constexpr int kEv = 32;     // events a unit stages, hashes and sums (one bit each in a mask)
constexpr int kItems = 2;   // (cell, float4 column) sums a thread holds
constexpr int kBufs = 3;    // units staged: one summed, one hashed, one in flight
constexpr int kSplit = 8;   // lanes that share an event pair's hash

typedef unsigned Mask;      // bit e: event e of a unit

struct UpdateLayout {
  size_t slice, r, x, w, sig, list, bar, total;
};

// Dynamic shared memory: the CTA's slice of the store row, its rows of R,
// kBufs buffers of kEv event rows and of their bucket ids (group-major),
// two of a unit's weights, the list of owned batch rows of a window with a
// count per warp, and kBufs + 3 mbarriers (R, the slice, the event
// buffers, and the first unit, which takes two arrivals: row b's events at
// the start and the rest of the unit once the owned rows are listed).
template <typename T>
__host__ __device__ inline UpdateLayout update_layout(int gmax, int U, int tau, int d) {
  UpdateLayout s;
  size_t o = 0;
  s.slice = o;
  o += align16(sizeof(float) * gmax * U * d);
  s.r = o;
  o += align16(sizeof(float) * gmax * tau * d);
  s.x = o;
  o += align16(sizeof(T) * kBufs * kEv * d);
  s.w = o;
  o += align16(sizeof(float) * 2 * kEv);
  s.sig = o;
  o += align16(sizeof(int) * kBufs * gmax * kEv);
  s.list = o;
  o += align16(sizeof(int) * (kThreads + kThreads / 32));
  s.bar = o;
  o += (kBufs + 3) * sizeof(unsigned long long);
  s.total = o;
  return s;
}

// Bucket ids of the n staged events x_s (n, d) in the ng groups whose
// projections r_s (ng * TAU, d) holds, into sig[gl * kEv + e]. kSplit lanes
// share two events and one group: lane j sums float4 columns j, j + kSplit,
// ... of both events' TAU projections, and a butterfly adds the partial sums.
template <typename T, int TAU>
__device__ __forceinline__ void hash_events(int* sig, const T* x_s, int n, int ng,
                                            const float* r_s, int d) {
  constexpr int U = 1 << TAU;
  const int part = threadIdx.x % kSplit, per_pass = blockDim.x / kSplit, nq = d / 4;
  const int pairs = (n + 1) / 2, items = pairs * ng;
  for (int base = 0; base < items; base += per_pass) {  // the same trip count for all
    const int i = base + threadIdx.x / kSplit;
    const bool on = i < items;
    const int gl = on ? i / pairs : 0, e0 = on ? 2 * (i - gl * pairs) : 0;
    const int e1 = min(e0 + 1, n - 1);
    float a[2][TAU];
#pragma unroll
    for (int t = 0; t < TAU; ++t) a[0][t] = a[1][t] = 0.f;
    if (on) {
      const T* x0 = x_s + (size_t)e0 * d;
      const T* x1 = x_s + (size_t)e1 * d;
      const float* r = r_s + (size_t)gl * TAU * d;
#pragma unroll 2
      for (int k4 = part; k4 < nq; k4 += kSplit) {
        const float4 v0 = load4(x0 + 4 * k4), v1 = load4(x1 + 4 * k4);
#pragma unroll
        for (int t = 0; t < TAU; ++t) {
          const float4 rv = load4(r + t * d + 4 * k4);
          a[0][t] = dot4(rv, v0, a[0][t]);
          a[1][t] = dot4(rv, v1, a[1][t]);
        }
      }
    }
    int bits[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int t = 0; t < TAU; ++t) {
        float v = a[e][t];
#pragma unroll
        for (int o = kSplit / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        bits[e] |= (v >= 0.f ? 1 : 0) << t;
      }
    if (on && part == 0) {
      sig[gl * kEv + e0] = bits[0];
      if (e0 + 1 < n) sig[gl * kEv + e0 + 1] = bits[1];
    }
  }
}

// For each of this thread's items (cell c0 + k * cpp, k < kItems), the mask
// of the unit's n events that fall in that cell (bit e: event e), from the
// bucket ids sig (ng, kEv). Each warp takes the cells its lanes hold, one
// ballot a cell in which lane e tests event e, so no thread scans the
// events and the masks need no atomic.
template <int U>
__device__ __forceinline__ void item_masks(Mask* in, const int* sig, int n, int cells, int c0,
                                           int cpp, int nq) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first = warp * 32 / nq, last = min((warp * 32 + 31) / nq, cpp - 1);
#pragma unroll
  for (int k = 0; k < kItems; ++k) in[k] = 0u;
  for (int cw = first; cw <= last; ++cw) {  // warp-uniform
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = cw + k * cpp, gl = c / U, u = c % U;
      const Mask m = __ballot_sync(0xffffffffu, c < cells && lane < n && sig[gl * kEv + lane] == u);
      if (c0 + k * cpp == c) in[k] = m;
    }
  }
}

template <typename T, int TAU>
__global__ void __launch_bounds__(kThreads, 2)
    sdim_update_kernel(float* __restrict__ store, const int* __restrict__ slots,
                       const T* __restrict__ events, const float* __restrict__ mask,
                       const float* __restrict__ R, int B, int E, int G, int d) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int S = gridDim.x, rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g0 = rank * G / S, ng = (rank + 1) * G / S - g0, gmax = (G + S - 1) / S;
  const int nq = d / 4, cells = ng * U;
  // a unit: rpu whole rows of E <= kEv events, or one batch of kEv of a
  // row's E > kEv events (nbat batches a row)
  const int rpu = E <= kEv ? kEv / E : 1, nbat = E <= kEv ? 1 : (E + kEv - 1) / kEv;
  // item k of this thread: float4 column k4 of cell c0 + k * cpp
  const int cpp = kThreads / nq, k4 = tid % nq, c0 = tid < cpp * nq ? tid / nq : cells;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const UpdateLayout lay = update_layout<T>(gmax, U, TAU, d);
  float* slice_s = reinterpret_cast<float*>(smem + lay.slice);  // (cells, d)
  float* r_s = reinterpret_cast<float*>(smem + lay.r);          // (ng * TAU, d)
  T* x_s = reinterpret_cast<T*>(smem + lay.x);                  // kBufs x (kEv, d)
  float* w_s = reinterpret_cast<float*>(smem + lay.w);          // 2 x (kEv,)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);          // kBufs x (gmax, kEv)
  int* list_s = reinterpret_cast<int*>(smem + lay.list);        // window list, then warp counts
  int* count_s = list_s + kThreads;
  // mbarriers: R, the slice, the event buffers, the first unit
  unsigned long long* bar_s = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  unsigned long long* first_bar = bar_s + 2 + kBufs;
  PHASE_BEGIN();

  // Unit u of a window of `count` owned rows: its list index r0, rows nr,
  // first event e0 and events a row ne (n = nr * ne). Events of row
  // list_s[r0 + s] fill staged rows [s * ne, (s + 1) * ne).
  struct Unit {
    int r0, nr, e0, ne;
  };
  auto unit = [&](int u, int count) {
    if (E <= kEv) return Unit{u * rpu, min(rpu, count - u * rpu), 0, E};
    const int j = u % nbat;
    return Unit{u / nbat, 1, j * kEv, min(kEv, E - j * kEv)};
  };
  // this thread's event of a unit: row st of it, event et of that row
  const int st = E <= kEv ? tid / E : 0, et = E <= kEv ? tid % E : tid;
  const bool bulk = (d * sizeof(T)) % 16 == 0;  // event rows of whole 16-byte pieces
  // rows [s_lo, nr) of unit un into buffer x (one bulk copy a row, lane s
  // of warp 0 issuing row s's, counted on bar with one arrival; without
  // bulk copies warp 0 copies the rows, then lane 0 arrives); returns this
  // thread's weight in those rows (0 elsewhere)
  auto stage = [&](const Unit& un, int s_lo, T* x, unsigned long long* bar) {
    if (warp == 0 && bulk) {
      if (lane == 0) mbar_expect(bar, (un.nr - s_lo) * un.ne * d * sizeof(T));
      __syncwarp();
      if (lane >= s_lo && lane < un.nr)
        bulk_copy(x + (size_t)lane * un.ne * d,
                  events + ((size_t)list_s[un.r0 + lane] * E + un.e0) * d,
                  un.ne * d * sizeof(T), bar);
    } else if (warp == 0) {
      const int pieces = un.ne * d * sizeof(T) / 8;
      for (int i = lane; i < (un.nr - s_lo) * pieces; i += 32) {
        const int s = s_lo + i / pieces, k = i % pieces;
        reinterpret_cast<uint2*>(x + (size_t)s * un.ne * d)[k] = __ldg(
            reinterpret_cast<const uint2*>(events + ((size_t)list_s[un.r0 + s] * E + un.e0) * d) +
            k);
      }
      __syncwarp();
      if (lane == 0) mbar_expect(bar, 0);  // a plain arrival, after the rows' stores
    }
    return st >= s_lo && st < un.nr && et < un.ne
               ? mask[(size_t)list_s[un.r0 + st] * E + un.e0 + et]
               : 0.f;
  };

  if (tid == 0) {  // R and row b's first events need no slot: in flight at once
    for (int k = 0; k < 2 + kBufs; ++k) mbar_init(bar_s + k);
    mbar_init(first_bar, 2);
    bulk_load(r_s, R + (size_t)g0 * TAU * d, ng * TAU * d * sizeof(float), bar_s);
    if (bulk) bulk_load(x_s, events + (size_t)b * E * d, min(E, kEv) * d * sizeof(T), first_bar);
  }
  if (!bulk && warp == 0) {  // row b's first events, copied by warp 0 (contiguous)
    const uint2* src = reinterpret_cast<const uint2*>(events + (size_t)b * E * d);
    for (int k = lane; k < min(E, kEv) * d * (int)sizeof(T) / 8; k += 32)
      reinterpret_cast<uint2*>(x_s)[k] = __ldg(src + k);
    __syncwarp();
    if (lane == 0) mbar_expect(first_bar, 0);  // after tid 0 initialized it
  }
  const float w_b = tid < min(E, kEv) ? mask[(size_t)b * E + tid] : 0.f;

  // the slot scan: an earlier batch row with this slot owns it. The slot
  // and the first window's slots are loaded together (one round trip for
  // b < kThreads); rows of earlier windows are scanned first.
  const int slot = __ldg(slots + b), p0 = b / kThreads * kThreads;
  const int s0 = p0 + tid < B ? __ldg(slots + p0 + tid) : -1;
  bool earlier = p0 + tid < b && s0 == slot;
  for (int i = tid; i < p0; i += kThreads) earlier |= __ldg(slots + i) == slot;
  float* row = store + ((size_t)slot * G + g0) * U * d;  // this CTA's slice of the row
  if (tid == 0) bulk_load(slice_s, row, cells * d * sizeof(float), bar_s + 1);
  if (__syncthreads_or(earlier)) {
    if (tid == 0) {  // no copy may land in shared memory after the CTA exits
      mbar_expect(first_bar, 0);  // the first unit's second arrival
      mbar_wait(bar_s, 0);
      mbar_wait(bar_s + 1, 0);
      mbar_wait(first_bar, 0);
    }
    PHASE_MARK(0);  // slot scan
    PHASE_END();
    return;
  }
  PHASE_MARK(0);  // slot scan

  // Units are numbered over the whole CTA (v): unit v is staged into buffer
  // v % kBufs, its bucket ids go to sig_s buffer v % kBufs and its weights to
  // w_s buffer v % 2. Each phase between two barriers sums unit v and
  // hashes unit v + 1, while unit v + 2 is in flight.
  float4 acc[kItems], delta[kItems];
  unsigned touched = 0;  // bit k: item k's cell was reached by a weighted event
#pragma unroll
  for (int k = 0; k < kItems; ++k) delta[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  bool have_slice = false;
  int nu = 0, ns = 0;   // units summed, units staged
  unsigned parity = 0;  // bit k: the parity of buffer k's next phase
  auto xbuf = [&](int v) { return x_s + (size_t)(v % kBufs) * kEv * d; };
  auto sigs = [&](int v) { return sig_s + (size_t)(v % kBufs) * gmax * kEv; };
  auto wait_unit = [&](int v) {  // R and unit v landed
    mbar_wait(bar_s, 0);
    if (v == 0) {
      mbar_wait(first_bar, 0);
    } else {
      const int k = v % kBufs;
      mbar_wait(bar_s + 2 + k, (parity >> k) & 1u);
      parity ^= 1u << k;
    }
  };
  for (int p = p0; p < B; p += kThreads) {
    // the window's batch rows >= b with this slot, in b order
    const int i = p + tid;
    const int si = p == p0 ? s0 : (i < B ? __ldg(slots + i) : -1);
    const bool mine = i >= b && si == slot;
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
    const int units = E <= kEv ? (count + rpu - 1) / rpu : count * nbat;
    if (units == 0) continue;

    // unit u of the window into the next buffer; this thread's weight in it
    auto stage_next = [&](int u) {
      const Unit un = unit(u, count);
      float w;
      if (ns == 0) {  // row b's events are in flight: the rest of the unit
        const float w_rest = stage(un, 1, x_s, first_bar);
        w = tid < un.ne ? w_b : w_rest;
      } else {
        w = stage(un, 0, xbuf(ns), bar_s + 2 + ns % kBufs);
      }
      ++ns;
      return w;
    };
    const float w0 = stage_next(0);
    float w1 = units > 1 ? stage_next(1) : 0.f, w2 = 0.f;
    if (tid < kEv) w_s[(nu & 1) * kEv + tid] = w0;
    __syncthreads();
    PHASE_MARK(0);  // slot scan
    wait_unit(nu);
    PHASE_MARK(1);  // waits
    {
      const Unit un = unit(0, count);
      hash_events<T, TAU>(sigs(nu), xbuf(nu), un.nr * un.ne, ng, r_s, d);
    }
    __syncthreads();
    PHASE_MARK(2);  // hash

    for (int u = 0; u < units; ++u, ++nu) {
      PHASE_MARK(2);  // hash
      if (u + 2 < units) w2 = stage_next(u + 2);
      PHASE_MARK(5);  // stage
      if (u + 1 < units && tid < kEv) w_s[((nu + 1) & 1) * kEv + tid] = w1;
      const Unit un = unit(u, count);
      const T* xb = xbuf(nu);
      const float* wu = w_s + (nu & 1) * kEv;
      Mask in[kItems];
      item_masks<U>(in, sigs(nu), un.nr * un.ne, cells, c0, cpp, nq);
      const Mask seg = un.ne == kEv ? ~Mask(0) : (Mask(1) << un.ne) - 1;
      for (int s = 0; s < un.nr; ++s) {  // the unit's rows in b order
        Mask mine_s[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k) mine_s[k] = in[k] & (seg << (s * un.ne));
        // the items' events of this row in e order, one event of every item
        // a step; an item without one adds 0 * x[0] (exact for finite x), so
        // the steps have no branch and the items' loads overlap
        for (;;) {
          Mask any = 0;
#pragma unroll
          for (int k = 0; k < kItems; ++k) any |= mine_s[k];
          if (!any) break;
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            const bool has = mine_s[k] != 0u;
            const int e = has ? __ffs(mine_s[k]) - 1 : 0;
            mine_s[k] &= mine_s[k] - 1u;
            const float we = has ? wu[e] : 0.f;
            delta[k] = axpy4(we, load4(xb + (size_t)e * d + 4 * k4), delta[k]);
            touched |= (we != 0.f ? 1u : 0u) << k;
          }
        }
        if (un.e0 + un.ne == E) {  // the row's bucket sums, added to the running total
          if (!have_slice) {       // the store slice, awaited only now
            mbar_wait(bar_s + 1, 0);
#pragma unroll
            for (int k = 0; k < kItems; ++k)
              acc[k] = c0 + k * cpp < cells
                           ? load4(slice_s + (size_t)(c0 + k * cpp) * d + 4 * k4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            have_slice = true;
          }
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            acc[k] = make_float4(acc[k].x + delta[k].x, acc[k].y + delta[k].y,
                                 acc[k].z + delta[k].z, acc[k].w + delta[k].w);
            delta[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
      PHASE_MARK(3);  // sums
      if (u + 1 < units) {  // the next unit's bucket ids, while other warps still sum
        wait_unit(nu + 1);
        PHASE_MARK(1);  // waits
        const Unit nx = unit(u + 1, count);
        hash_events<T, TAU>(sigs(nu + 1), xbuf(nu + 1), nx.nr * nx.ne, ng, r_s, d);
      }
      __syncthreads();  // unit nu read, unit nu + 1's bucket ids and weights written
      PHASE_MARK(2);    // hash
      w1 = w2;
      w2 = 0.f;
    }
  }

  // only the cells that some weighted event reached, once, 16 bytes a store
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if ((touched >> k) & 1u)
      *reinterpret_cast<float4*>(row + (size_t)(c0 + k * cpp) * d + 4 * k4) = acc[k];
  PHASE_MARK(4);  // write
  PHASE_END();
}

template <typename T, int TAU>
static cudaError_t launch(float* store, const int* slots, const void* events, const float* mask,
                          const float* R, int B, int E, int G, int d, int S,
                          cudaStream_t stream) {
  const int U = 1 << TAU, gmax = S > 0 ? (G + S - 1) / S : 0;
  if (d <= 0 || d % 4 != 0 || d > 128 || S < 1 || S > G ||
      gmax * U > kItems * (kThreads / (d / 4)))
    return cudaErrorInvalidValue;
  if (B == 0 || E == 0) return cudaSuccess;
  const size_t smem = update_layout<T>(gmax, U, TAU, d).total;
  const void* fn = reinterpret_cast<const void*>(sdim_update_kernel<T, TAU>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  sdim_update_kernel<T, TAU><<<dim3(S, B), kThreads, smem, stream>>>(
      store, slots, static_cast<const T*>(events), mask, R, B, E, G, d);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_tau(float* store, const int* slots, const void* events,
                              const float* mask, const float* R, int B, int E, int G, int d,
                              int tau, int S, cudaStream_t stream) {
  switch (tau) {
    case 1: return launch<T, 1>(store, slots, events, mask, R, B, E, G, d, S, stream);
    case 2: return launch<T, 2>(store, slots, events, mask, R, B, E, G, d, S, stream);
    case 3: return launch<T, 3>(store, slots, events, mask, R, B, E, G, d, S, stream);
    case 4: return launch<T, 4>(store, slots, events, mask, R, B, E, G, d, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim

PHASE_READER(sdim_update_phases)

// store (N, G*U, d) fp32 updated in place; slots (B,) int32 in [0, N);
// events (B, E, d) fp32|bf16; mask (B, E) fp32; R (m, d) fp32; S group
// slices per batch row (tau <= 4 at d <= 128); work: B*G*U*d floats of
// scratch where the large-tau path (tau > 4 or d > 128) takes E > 8,192 in
// chunks, else unused (null).
extern "C" int sdim_update(float* store, const int* slots, const void* events, int ev_dtype,
                           const float* mask, const float* R, float* work, int B, int E, int G,
                           int U, int d, int m, int tau, int S, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4 || d > 128)  // large_tau.cuh
    return sdim::launch_update_large_tau(store, slots, events, ev_dtype, mask, R, work, B, E, G,
                                         U, d, tau, s);
  switch (ev_dtype) {
    case sdim::kF32:
      return sdim::launch_tau<float>(store, slots, events, mask, R, B, E, G, d, tau, S, s);
    case sdim::kBF16:
      return sdim::launch_tau<__nv_bfloat16>(store, slots, events, mask, R, B, E, G, d, tau, S,
                                             s);
    default:
      return cudaErrorInvalidValue;
  }
}
