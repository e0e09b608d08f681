// K4, K5 and K6: the banded and semi-global sweeps of the general alignment
// API (stringdecomposer_tpu_torch/ops/align.py), their wide routes.
//
//   K4  banded_kernel replaces stringdecomposer_tpu/ops/banded_pallas.py::
//       _kernel (via banded_final_column_pallas): the final target column of
//       the banded NW DP, |i - j| <= k, in int32 cells, on plain codes or on
//       equality bitmasks. Its twin is ops/align.dp_banded_lastrow_batch.
//   K5  myers_kernel replaces banded_pallas.py::_myers_kernel (via
//       banded_final_column_myers): the same column by bit-parallel banded
//       Myers, 32 band rows per word, with the NW boundary inside the band.
//       It emits the VP/VN planes and the anchor captured at j == t_len; the
//       wrapper rebuilds the column by a cumsum. Twin:
//       ops/banded.banded_final_column_myers.
//   K6  semi_wide_kernel replaces banded_pallas.py::_semi_kernel (via
//       semi_ends_myers): full-height Myers over every target column, the
//       end-row score D(q_len, j) of HW (free target prefix) or SHW. Twin:
//       ops/banded.semi_ends_myers; mirror: ops/banded.semi_staged.
// These are the wide routes: K4 past 512 band lanes (k >= 256; the warp
// route is csrc/banded_warp.cu), K5 and K6 past 512 words (the warp route
// is csrc/myers_warp.cu).
//
// What bounds them on the H100: latency. Each pair is a chain of t_len
// dependent target columns, and a column is only a few integer operations
// per band lane (K4) or per 32-row word (K5, K6), so neither device-memory
// bytes nor ALU throughput is the limit: the time is the number of columns
// times the latency of one column step.
//   - K4 and K5: one block runs one pair and loops over its target columns; a
//     column is two (K4) or three (K5) block barriers around in-place passes
//     over the band, which lives in shared memory while it fits and in a
//     per-pair device-memory scratch beyond that, so no band width is
//     refused. Thread tid owns the R consecutive items tid * R .. tid * R +
//     R - 1 (band lanes or words), stored at r * T + tid so that a pass over
//     r touches consecutive addresses. The within-column chains are block
//     scans: the K4 up chain is a prefix min of cand - b (warp shuffles, then
//     the warp totals through shared memory), the Myers addition's carry a
//     prefix of (generate, propagate) pairs the same way.
//   - K6: a block per pair (per target segment under HW), its column cut
//     into stages of kWideR words, one a thread, in registers with the
//     stage's Peq words (the compact codes 0-3; built once per pair by
//     ballots). The stages run as a pipeline: at step t stage s steps column
//     t - s and hands the next stage its link (the add's carry out, the HP /
//     HN bits of its top row): up a lane by a shuffle, from lane 31 to the
//     next warp's lane 0 through a double-buffered shared slot, one barrier
//     a step (the column step and the handoff in csrc/myers_wide.cuh, shared
//     with K3's wide route, csrc/hw_filter.cu). Up to 512 stages
//     (131,072 rows) run at once; a taller query runs in bands of stages one
//     after the other, each band's top links a column kept in device memory
//     for the next band. Only the stages up to the end row's run. Under HW a
//     long target is cut into segments warm-started 2 q_len columns back, as
//     the warp route's (ops/banded_cuda.wide_segment_plan picks them).
// The Pallas kernels' right-aligned lanes, roll ladders, 128-lane tiles and
// column-tile grid exist for Mosaic and are not carried over.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "myers_wide.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 28;
constexpr int kSlots = 32;  // one shared slot per warp of a 1024-thread block

// ---------------------------------------------------------------------------
// block scans (blockDim.x a multiple of 32); each holds one __syncthreads
// ---------------------------------------------------------------------------

// Exclusive prefix min, over the block's threads, of `v` (INT_MAX for
// thread 0).
__device__ int block_excl_min(int v, int* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = min(incl, u);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = INT_MAX;
  if (lane == 31) slots[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl = min(excl, slots[w]);
  return excl;
}

// A span of words under addition: bit 0 = generate (a carry leaves the span
// with none entering), bit 1 = propagate (an entering carry leaves). `hi`
// is the span above `lo`.
__device__ __forceinline__ unsigned gp_combine(unsigned lo, unsigned hi) {
  const unsigned p = (hi >> 1) & 1;
  return ((hi & 1) | (p & lo & 1)) | ((p & (lo >> 1)) << 1);
}

// The carry into this thread's lowest word, given the thread's aggregate
// (generate, propagate) over its words; no carry enters word 0.
__device__ unsigned block_carry_in(unsigned gp, unsigned* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = gp;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = gp_combine(u, incl);
  }
  unsigned excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 2u;  // the empty span: propagate, no generate
  if (lane == 31) slots[warp] = incl;
  __syncthreads();
  unsigned c = 0;
  for (int w = 0; w < warp; ++w) c = (slots[w] & 1) | ((slots[w] >> 1) & c);
  return (excl & 1) | ((excl >> 1) & c);
}

// Mask of global bits 0..b0 within word w (empty when b0 < 0).
__device__ __forceinline__ unsigned lowmask(int w, int b0) {
  const int n = min(max(b0 + 1 - 32 * w, 0), 32);
  return n >= 32 ? kFull : (1u << n) - 1u;
}

// ---------------------------------------------------------------------------
// K4: the int32 band
// ---------------------------------------------------------------------------

// Lane b at column j holds row i = j + b - k. D holds the band at column
// j - 1 on entry; `right` is D[b + 1] for the thread's last lane (the next
// thread's first, cached before anyone writes). Returns cand - b, the value
// the up chain folds.
template <bool kMask>
__device__ __forceinline__ int band_cand(const int* __restrict__ qp, int Lq, int ql,
                                         int tc, int j, int k, int b, int dcur,
                                         int dleft) {
  const int i = j + b - k;
  const int code = (i >= 1 && i <= Lq) ? qp[i - 1] : (kMask ? 0 : -1);
  const int sub = kMask ? 1 - ((code >> tc) & 1) : (code != tc ? 1 : 0);
  int c = min(dleft + 1, dcur + sub);
  if (i == 0) c = j;  // the NW boundary row enters while j <= k
  if (i < 0 || i > ql) c = kBig;
  return c - b;
}

template <bool kMask>
__global__ void __launch_bounds__(1024)
banded_kernel(const int* __restrict__ q,      // [P, Lq] codes or bitmasks
              const int* __restrict__ qlens,  // [P]
              const int* __restrict__ t,      // [P, Lt] codes or symbol ids
              const int* __restrict__ tlens,  // [P]
              int* scratch,                   // [P, R * T] or null (shared)
              int* __restrict__ out,          // [P, 2k + 1]
              int Lq, int Lt, int k, int R) {
  extern __shared__ int smem[];
  const int p = blockIdx.x, T = blockDim.x, tid = threadIdx.x;
  const int Bw = 2 * k + 1;
  int* slots = smem;
  int* D = scratch ? scratch + (long long)p * R * T : smem + kSlots;
  const int ql = qlens[p], tl = tlens[p];
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt;
  const int b0 = tid * R;
  for (int r = 0; r < R; ++r) {  // column 0: D(i, 0) = i
    const int i = b0 + r - k;
    D[r * T + tid] = (i >= 0 && i <= ql) ? i : kBig;
  }
  __syncthreads();
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;  // -1: never captured
  for (int j = 1; j <= n; ++j) {
    const int tc = tp[j - 1];
    const int right = (b0 + R < Bw && tid + 1 < T) ? D[tid + 1] : kBig;
    int run = INT_MAX;
    for (int r = 0; r < R && b0 + r < Bw; ++r) {
      const int b = b0 + r;
      const int dl = b + 1 >= Bw ? kBig : (r + 1 < R ? D[(r + 1) * T + tid] : right);
      run = min(run, band_cand<kMask>(qp, Lq, ql, tc, j, k, b, D[r * T + tid], dl));
    }
    int excl = block_excl_min(run, slots);
    // in place, lanes ascending: lane b + 1 is still column j - 1 when lane b reads it
    for (int r = 0; r < R && b0 + r < Bw; ++r) {
      const int b = b0 + r, i = j + b - k;
      const int dl = b + 1 >= Bw ? kBig : (r + 1 < R ? D[(r + 1) * T + tid] : right);
      excl = min(excl, band_cand<kMask>(qp, Lq, ql, tc, j, k, b, D[r * T + tid], dl));
      D[r * T + tid] = (i >= 0 && i <= ql) ? excl + b : kBig;
    }
    __syncthreads();
  }
  for (int r = 0; r < R && b0 + r < Bw; ++r)
    out[(long long)p * Bw + b0 + r] = n < 0 ? kBig : min(D[r * T + tid], kBig);
}

// ---------------------------------------------------------------------------
// K5: Myers word planes
// ---------------------------------------------------------------------------

// The query code of row i + 1 (q index i) as the Peq planes see it: rows at
// or past q_len, and outside the array, match nothing.
__device__ __forceinline__ int qcode(const int* __restrict__ qp, int Lq, int ql, int i) {
  return (i >= 0 && i < Lq && i < ql) ? qp[i] : -9;
}

// Word w of plane c (c = 0..3) over rows base + 32 w + bit.
__device__ unsigned plane_word(const int* __restrict__ qp, int Lq, int ql, int base,
                               int nbits, int w, int c) {
  unsigned x = 0;
  for (int bit = 0; bit < 32; ++bit) {
    const int b = 32 * w + bit;
    if (b < nbits && qcode(qp, Lq, ql, base + b) == c) x |= 1u << bit;
  }
  return x;
}

// The scratch planes of one pair, each of R * T words.
struct Planes {
  unsigned *vp, *vn, *pl, *d0, *hp, *hn;  // pl: 4 planes back to back
};

__device__ __forceinline__ Planes planes_at(unsigned* base, int RT) {
  return {base, base + RT, base + 2 * RT, base + 6 * RT, base + 7 * RT, base + 8 * RT};
}
constexpr int kPlaneArrays = 9;

__device__ __forceinline__ unsigned eq_word(const Planes& s, int RT, int tc, int at) {
  return (tc >= 0 && tc < 4) ? s.pl[tc * RT + at] : 0u;
}

// K5's per-word inputs to the addition at column j (b0 = k - j): the state
// slid one row down (bit b <- bit b + 1), the carry chain cut at and below
// the boundary lane b0.
struct MyersIn {
  unsigned vpsc, x, vns;
};

__device__ __forceinline__ MyersIn myers_in(const Planes& s, int RT, int T, int R, int W,
                                            int tid, int r, int tc, int topw,
                                            unsigned topbit, int b0, unsigned next_vp,
                                            unsigned next_vn) {
  const int w = tid * R + r, at = r * T + tid;
  // bit 0 of the word above: the next own word, or the next thread's first
  const unsigned up_vp = w + 1 >= W ? 0u : (r + 1 < R ? s.vp[at + T] : next_vp);
  const unsigned up_vn = w + 1 >= W ? 0u : (r + 1 < R ? s.vn[at + T] : next_vn);
  unsigned vps = (s.vp[at] >> 1) | ((up_vp & 1u) << 31);
  if (w == topw) vps |= topbit;
  const unsigned vns = (s.vn[at] >> 1) | ((up_vn & 1u) << 31);
  const unsigned low = b0 >= 0 ? lowmask(w, b0) : 0u;
  return {vps & ~low, (eq_word(s, RT, tc, at) | vns) & ~low, vns};
}

__global__ void __launch_bounds__(1024)
myers_kernel(const int* __restrict__ q,      // [P, Lq] compact codes (0..3 match)
             const int* __restrict__ qlens,  // [P]
             const int* __restrict__ t,      // [P, Lt] compact codes
             const int* __restrict__ tlens,  // [P]
             unsigned* scratch,              // [P, 9 * R * T] or null (shared)
             unsigned* __restrict__ cvp,     // [P, W] captured VP
             unsigned* __restrict__ cvn,     // [P, W] captured VN
             int* __restrict__ ca,           // [P] captured anchor
             int Lq, int Lt, int k, int W, int R) {
  extern __shared__ unsigned smem_u[];
  const int p = blockIdx.x, T = blockDim.x, tid = threadIdx.x, RT = R * T;
  const int Bw = 2 * k + 1, topw = (Bw - 1) / 32;
  const unsigned topbit = 1u << ((Bw - 1) % 32);
  unsigned* slots = smem_u;
  const Planes s = planes_at(scratch ? scratch + (long long)p * kPlaneArrays * RT
                                     : smem_u + kSlots, RT);
  const int ql = qlens[p], tl = tlens[p];
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt;
  const int wfirst = tid * R;
  // column 0: anchor k, a -1 ramp below row 0 (lanes 1..k), +1 above; the
  // planes of column 1 hold q index b - k at lane b
  for (int r = 0; r < R; ++r) {
    const int w = wfirst + r, at = r * T + tid;
    if (w >= W) break;
    const unsigned lanemask = lowmask(w, Bw - 1), km = lowmask(w, k);
    s.vp[at] = ~km & lanemask;
    s.vn[at] = km & ~lowmask(w, 0) & lanemask;
    for (int c = 0; c < 4; ++c) s.pl[c * RT + at] = plane_word(qp, Lq, ql, -k, Bw, w, c);
  }
  int a = k;
  __syncthreads();
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;
  const bool last_own = wfirst + R < W;  // a next thread owns word wfirst + R
  for (int j = 1; j <= n; ++j) {
    const int tc = tp[j - 1], b0 = k - j;
    const unsigned next_vp = last_own ? s.vp[tid + 1] : 0u;
    const unsigned next_vn = last_own ? s.vn[tid + 1] : 0u;
    unsigned next_pl[4];
    for (int c = 0; c < 4; ++c) next_pl[c] = last_own ? s.pl[c * RT + tid + 1] : 0u;
    // pass 1: the thread's (generate, propagate) over its words
    unsigned gp = 2u;
    for (int r = 0; r < R && wfirst + r < W; ++r) {
      const MyersIn in = myers_in(s, RT, T, R, W, tid, r, tc, topw, topbit, b0, next_vp,
                                  next_vn);
      const unsigned sum = (in.x & in.vpsc) + in.vpsc;
      gp = gp_combine(gp, (sum < in.vpsc ? 1u : 0u) | (sum == kFull ? 2u : 0u));
    }
    unsigned carry = block_carry_in(gp, slots);
    // pass 2: the addition with its carries; the horizontal deltas
    for (int r = 0; r < R && wfirst + r < W; ++r) {
      const int w = wfirst + r, at = r * T + tid;
      const MyersIn in = myers_in(s, RT, T, R, W, tid, r, tc, topw, topbit, b0, next_vp,
                                  next_vn);
      const unsigned part = (in.x & in.vpsc) + in.vpsc;
      const unsigned sum = part + carry;
      carry = (part < in.vpsc ? 1u : 0u) | (part == kFull ? carry : 0u);
      const unsigned d0 = (sum ^ in.vpsc) | in.x;
      const unsigned bnd = (b0 >= 0 && w == b0 / 32) ? 1u << (b0 % 32) : 0u;
      const unsigned hp = (in.vns | ~(d0 | in.vpsc)) | bnd;  // boundary row: +1
      const unsigned hn = (d0 & in.vpsc) & ~bnd;
      s.d0[at] = d0;
      s.hp[at] = hp;
      s.hn[at] = hn;
      if (w == 0 && j > k)  // the anchor is constant k while lane 0 is virtual
        a += (int)((s.vp[at] >> 1) & 1u) - (int)((s.vn[at] >> 1) & 1u) + (int)(hp & 1u) -
             (int)(hn & 1u);
    }
    __syncthreads();
    // pass 3: the new vertical deltas; the Peq planes slide one row down
    const int inc = qcode(qp, Lq, ql, k + j);  // the row entering the band top
    for (int r = 0; r < R && wfirst + r < W; ++r) {
      const int w = wfirst + r, at = r * T + tid;
      const unsigned below_hp = w == 0 ? 1u : ((r > 0 ? s.hp[at - T] : s.hp[(R - 1) * T + tid - 1]) >> 31);
      const unsigned below_hn = w == 0 ? 0u : ((r > 0 ? s.hn[at - T] : s.hn[(R - 1) * T + tid - 1]) >> 31);
      const unsigned hpsh = (s.hp[at] << 1) | below_hp;  // out-of-band cell above lane 0: +1
      const unsigned hnsh = (s.hn[at] << 1) | below_hn;
      const unsigned d0 = s.d0[at];
      const unsigned lanemask = lowmask(w, Bw - 1);
      const unsigned bnd = (b0 >= 0 && w == b0 / 32) ? 1u << (b0 % 32) : 0u;
      const unsigned low = b0 >= 0 ? lowmask(w, b0) : 0u;
      const unsigned lowx = low & ~bnd, nob0 = b0 >= 1 ? bnd : 0u;
      const unsigned not0 = w == 0 ? ~1u : kFull;
      // virtual lanes strictly below the boundary keep the -1 ramp; the
      // boundary lane's own vertical delta is -1
      s.vp[at] = (hnsh | ~(d0 | hpsh)) & lanemask & ~lowx & ~nob0;
      s.vn[at] = (((d0 & hpsh) & lanemask & ~lowx) | (lowx & not0) | nob0) & lanemask;
      for (int c = 0; c < 4; ++c) {
        const unsigned above = w + 1 >= W ? 0u : (r + 1 < R ? s.pl[c * RT + at + T] : next_pl[c]);
        unsigned x = (s.pl[c * RT + at] >> 1) | ((above & 1u) << 31);
        if (w == topw && inc == c) x |= topbit;
        s.pl[c * RT + at] = x;
      }
    }
    __syncthreads();
  }
  for (int r = 0; r < R && wfirst + r < W; ++r) {
    const int at = r * T + tid;
    cvp[(long long)p * W + wfirst + r] = n < 0 ? 0u : s.vp[at];
    cvn[(long long)p * W + wfirst + r] = n < 0 ? 0u : s.vn[at];
  }
  if (tid == 0) ca[p] = a;
}

// ---------------------------------------------------------------------------
// K6's wide route: full-height Myers as a pipeline of register stages
// ---------------------------------------------------------------------------

using sd_wide::kWideMaxStages;
using sd_wide::kWideR;

// Block g runs segment g % nseg of pair g / nseg: output columns [e_s, e_e),
// e_s = (g % nseg) * S, stepped from j0 = max(0, e_s - 2 q_len) on (exact
// under HW for the reason myers_warp.cu's semi_warp_kernel gives; SHW runs
// nseg = 1). Thread s is stage s of every band: the query's words
// (band * stages + s) * kWideR .. + kWideR - 1. Only the stages up to the
// end row's (bit q_len - 1) run: carries and up-shifts move up only, so no
// word above it reaches D(q_len, j).
__global__ void __launch_bounds__(kWideMaxStages)
    semi_wide_kernel(const int* __restrict__ q,      // [P, Lq] compact codes (0..3 match)
                     const int* __restrict__ qlens,  // [P]
                     const int* __restrict__ t,      // [P, Lt] compact codes
                     uint8_t* __restrict__ tops,     // [P * nseg, ncap] (bands > 1)
                     int* __restrict__ ends,         // [P, Lt]
                     int Lq, int Lt, int W, int stages, unsigned hp0, int nseg, int S,
                     int ncap) {
  __shared__ unsigned hand[2][kWideMaxStages / 32];  // sd_wide::hand_up's slots
  const int g = blockIdx.x, p = g / nseg, e_s = (g % nseg) * S;
  const int e_e = min(Lt, e_s + S);
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5;
  const int ql = qlens[p];
  int* ep = ends + (long long)p * Lt;
  const int hot_w = ql > 0 ? (ql - 1) >> 5 : -1;
  if (hot_w < 0 || hot_w >= W) {  // no end row among the words: the score stays q_len
    for (int c = e_s + s; c < e_e; c += blockDim.x) ep[c] = ql;
    return;
  }
  const int j0 = max(0, e_s - 2 * ql), ncols = e_e - j0;
  // the end row's stage, its band and its place in the band
  const int hs = hot_w / kWideR, hb = hs / stages, hsl = hs % stages;
  const int hot_r = hot_w % kWideR, hot_b = (ql - 1) & 31;
  const int qend = min(Lq, ql);  // rows at or past it match nothing
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt + j0;
  uint8_t* top = tops ? tops + (long long)g * ncap : nullptr;
  int score = ql;  // D(q_len, j0) = q_len
  for (int band = 0; band <= hb; ++band) {
    const int used = band < hb ? stages : hsl + 1;  // the stages this band runs
    const bool live = s < used, hot = band == hb && s == hsl;
    // the stage's Peq words, a warp's 256 words at once: lanes load 32 rows
    // a word, one ballot a code, the owner keeps it
    unsigned pq0[kWideR], pq1[kWideR], pq2[kWideR], pq3[kWideR], vp[kWideR], vn[kWideR];
#pragma unroll
    for (int r = 0; r < kWideR; ++r) {
      pq0[r] = pq1[r] = pq2[r] = pq3[r] = 0u;
      vp[r] = kFull;  // column j0: all +1
      vn[r] = 0u;
    }
    if (32 * warp < used) {  // the whole warp
      const int wbase = (band * stages + 32 * warp) * kWideR;
      for (int l = 0; l < 32; ++l) {
#pragma unroll
        for (int r = 0; r < kWideR; ++r) {
          const int row0 = 32 * (wbase + l * kWideR + r);
          if (row0 < qend) {  // the whole warp
            const int code = row0 + lane < qend ? __ldg(qp + row0 + lane) : -9;
            const unsigned m0 = __ballot_sync(kFull, code == 0), m1 = __ballot_sync(kFull, code == 1);
            const unsigned m2 = __ballot_sync(kFull, code == 2), m3 = __ballot_sync(kFull, code == 3);
            if (lane == l) {
              pq0[r] = m0;
              pq1[r] = m1;
              pq2[r] = m2;
              pq3[r] = m3;
            }
          }
        }
      }
    }
    // stage s steps column c = step - s; its target code (and stage 0's link
    // from the band below) is fetched a step ahead
    int tnext = (s == 0 && ncols > 0) ? __ldg(tp) : -1;
    unsigned lnext = (band > 0 && s == 0 && ncols > 0) ? top[0] : hp0 << 1;
    unsigned in = 0u;  // the link from the stage below, for this step's column
    for (int step = 0; step < ncols + used - 1; ++step) {
      const int c = step - s;
      const bool act = live && c >= 0 && c < ncols;
      const int tc = tnext;
      unsigned link = s > 0 ? in : lnext;
      if (live && c + 1 >= 0 && c + 1 < ncols) {
        tnext = __ldg(tp + c + 1);
        if (s == 0 && band > 0) lnext = top[c + 1];
      }
      if (act) {
        unsigned eq[kWideR];
#pragma unroll
        for (int r = 0; r < kWideR; ++r)
          eq[r] = tc == 0 ? pq0[r] : tc == 1 ? pq1[r] : tc == 2 ? pq2[r] : tc == 3 ? pq3[r] : 0u;
        const int d = sd_wide::stage_column(vp, vn, eq, link, hot ? hot_r : -1, hot_b);
        if (hot) {
          score += d;
          if (j0 + c >= e_s) ep[j0 + c] = score;
        }
        if (s == stages - 1 && band < hb) top[c] = (uint8_t)link;
      }
      in = sd_wide::hand_up(link, hand, step);
    }
    __syncthreads();  // every read of `hand` done before the next band writes it
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// K4's and K5's entry points take the block size T (a multiple of 32, at most
// 1024) and R items per thread from the wrapper (ops/banded_cuda.py), and
// `scratch` null when the band's arrays fit shared memory, else a
// per-pair device-memory scratch of the size given there.
extern "C" int sd_banded_column(const void* q, const void* qlens, const void* t,
                                const void* tlens, void* scratch, void* out, int P, int Lq,
                                int Lt, int k, int use_mask, int T, int R, void* stream) {
  if (P <= 0) return 0;
  const size_t bytes = (kSlots + (scratch ? 0 : (size_t)R * T)) * sizeof(int);
  const void* fn = use_mask ? (const void*)banded_kernel<true> : (const void*)banded_kernel<false>;
  int err = set_smem(fn, bytes);
  if (err) return err;
  auto kern = use_mask ? banded_kernel<true> : banded_kernel<false>;
  kern<<<P, T, bytes, (cudaStream_t)stream>>>((const int*)q, (const int*)qlens, (const int*)t,
                                              (const int*)tlens, (int*)scratch, (int*)out, Lq,
                                              Lt, k, R);
  return (int)cudaGetLastError();
}

extern "C" int sd_banded_myers(const void* q, const void* qlens, const void* t,
                               const void* tlens, void* scratch, void* cvp, void* cvn,
                               void* ca, int P, int Lq, int Lt, int k, int W, int T, int R,
                               void* stream) {
  if (P <= 0) return 0;
  const size_t bytes =
      (kSlots + (scratch ? 0 : (size_t)kPlaneArrays * R * T)) * sizeof(unsigned);
  int err = set_smem((const void*)myers_kernel, bytes);
  if (err) return err;
  myers_kernel<<<P, T, bytes, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)qlens, (const int*)t, (const int*)tlens,
      (unsigned*)scratch, (unsigned*)cvp, (unsigned*)cvn, (int*)ca, Lq, Lt, k, W, R);
  return (int)cudaGetLastError();
}

// K6's wide route: q [P, Lq], t [P, Lt] int32 compact codes, qlens [P];
// ends [P, Lt]. W = max(1, ceil(Lq / 32)) words in bands of `stages` stages
// (threads: a multiple of 32, at most kWideMaxStages) of kWideR words,
// bands * stages * kWideR >= W. nseg segments of S columns a pair (nseg * S
// >= Lt; nseg > 1 only under HW, hp0 = 0, and S a multiple of 32); where
// bands > 1, tops is a [P * nseg, ncap] byte scratch, ncap >= min(Lt, S +
// 64 W) (a segment's columns and its warm-up).
extern "C" int sd_semi_wide(const void* q, const void* qlens, const void* t, void* tops,
                            void* ends, int P, int Lq, int Lt, int W, int stages, int bands,
                            int hp0, int nseg, int S, int ncap, void* stream) {
  if (P <= 0 || Lt <= 0) return 0;
  const long long span = (long long)S + 64LL * W;  // a segment's columns and its warm-up
  if (W != (Lq > 32 ? (Lq + 31) / 32 : 1) || stages < 32 || stages > kWideMaxStages ||
      stages % 32 || bands < 1 || (long long)bands * stages * kWideR < W || nseg < 1 ||
      (long long)nseg * S < Lt || (nseg > 1 && (hp0 || S % 32 != 0)) ||
      (long long)P * nseg > 0x7fffffffLL ||
      (bands > 1 && (!tops || ncap < (span < Lt ? span : (long long)Lt))))
    return (int)cudaErrorInvalidValue;
  semi_wide_kernel<<<(unsigned)(P * nseg), stages, 0, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)qlens, (const int*)t, (uint8_t*)tops, (int*)ends, Lq, Lt, W,
      stages, hp0 ? 1u : 0u, nseg, S, ncap);
  return (int)cudaGetLastError();
}

// Blocks of K6's wide kernel at `stages` threads that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its registers).
extern "C" int sd_semi_wide_occupancy(int stages, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, semi_wide_kernel, stages, 0);
}
