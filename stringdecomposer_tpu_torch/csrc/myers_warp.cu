// K5 and K6, the warp route: bit-parallel Myers a warp per pair (K6: per
// target segment), the band in registers. csrc/banded.cu keeps the block
// kernels as the wide route (more than kMaxR * 32 = 512 words).
//
//   K5  myers_warp_kernel replaces stringdecomposer_tpu/ops/banded_pallas.py::
//       _myers_kernel (via banded_final_column_myers): the final target
//       column of banded NW, |i - j| <= k, 32 band rows a word, the NW
//       boundary inside the band; it emits VP / VN and the anchor captured at
//       j == t_len, and the wrapper rebuilds the column by a cumsum. Twin:
//       ops/banded.banded_final_column_myers; mirror: ops/banded.myers_warp.
//   K6  semi_warp_kernel replaces banded_pallas.py::_semi_kernel (via
//       semi_ends_myers): full-height Myers over every target column, the
//       end-row score D(q_len, j) under HW (free target prefix) or SHW.
//       Twin: ops/banded.semi_ends_myers; mirror: ops/banded.semi_warp.
//
// What bounds them on the H100: latency. A pair is a chain of dependent
// target columns, each a few integer operations a 32-row word, so the time is
// the number of columns times the latency of one column step. The design
// shortens that step and, for HW, cuts the chain:
//   - One warp a pair. Lane l owns the R = ceil(W / 32) consecutive words
//     l*R .. l*R + R - 1 of VP and VN in registers (R a template parameter,
//     1..16). The column loop has no block barrier, and nothing of the column
//     goes through shared or device memory. A block holds kWarps pairs.
//   - The addition's carry across words: each lane reduces its R words to a
//     (generate, propagate) pair, the two exclusive; two ballots give the
//     masks G and P over the lanes, and with A = G | P, bit l of
//     (A + G) ^ A ^ G is the carry into lane l (no carry enters word 0). The
//     lane does the same add on R-bit masks of its own words in place of a
//     ripple (lane_carries), so a column's chain holds no loop over words.
//   - The seams by shuffle: K5's slide (bit b <- bit b + 1 across words: bit 0
//     of the next lane's first word, VP and VN packed in one __shfl_down_sync)
//     and the HP / HN up-shift (bit 31 of the lane below's last word, one
//     __shfl_up_sync; lane 0 takes the boundary bit); within a lane both are
//     funnel shifts. A lane finishes its words 1..R-1 as it computes HP / HN
//     and its word 0 after the shuffle.
//   - A column is a few hundred instructions a warp at R = 4, so a lone warp
//     waits on its chain and several warps an SM share its issue: what the
//     step costs is its instruction count, which the above keeps low.
//   - No sliding Peq planes. A prologue (peq_bitmaps_kernel) packs the
//     query's per-code bitmaps once per pair. K6 keeps its 4 * R Peq words in
//     registers. K5's band moves down one row a column, so it reads the
//     bitmaps over absolute rows (bit p = query index p - k - 1; at column j
//     band lane b is bit j + b) as a funnel shift of two words at the band's
//     offset, from device memory through L1 / L2: a pair's bitmaps span
//     k + q_len rows (133 KB at the 262,144 bp path's top level), more than a
//     block of several pairs could hold in shared memory, and the band's
//     window slides by one bit a column, so each word is read from L1 for 32
//     columns running. Those loads do not depend on the state and are issued
//     a column ahead.
//   - Target codes are staged 32 columns at a time, one coalesced load a
//     lane, broadcast by __shfl_sync a column, the next 32 loaded ahead. K6
//     buffers 32 end scores across the lanes and stores them together.
//   - K6 under HW splits a long target into segments of S columns, one warp
//     each, which start fresh max(0, e_s - 2 * q_len) columns before their
//     first output (the wrapper's segment_plan picks S; see semi_warp_kernel
//     for why that is exact). SHW runs one warp a pair.
// lane_carries and K6's column step (semi_column) live in myers_warp.cuh,
// which K3's warp route (hw_filter.cu) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_warp.cuh"

namespace {

using sd_warp::kFull;
using sd_warp::lane_carries;
constexpr int kWarps = 8;  // pairs (K6: segments) a block
constexpr int kMaxR = 16;  // words a lane: the route takes W <= 512 words

// Mask of global bits 0..b0 within word w (empty when b0 < 0).
__device__ __forceinline__ unsigned lowmask(int w, int b0) {
  const int n = min(max(b0 + 1 - 32 * w, 0), 32);
  return n >= 32 ? kFull : (1u << n) - 1u;
}

// Per-code bitmaps of the query, [P, 4, NB] words: bit b of word m of plane
// c is set where query index 32 m + b - off (< min(q_len, Lq)) holds code c.
__global__ void peq_bitmaps_kernel(const int* __restrict__ q, const int* __restrict__ qlens,
                                   unsigned* __restrict__ bm, int P, int Lq, int off, int NB) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)P * NB) return;
  const int p = (int)(g / NB), m = (int)(g % NB);
  const int ql = min(qlens[p], Lq);
  const int* qp = q + (long long)p * Lq;
  unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int i = 32 * m + b - off;
    const int c = (i >= 0 && i < ql) ? __ldg(qp + i) : -9;
    w0 |= (unsigned)(c == 0) << b;
    w1 |= (unsigned)(c == 1) << b;
    w2 |= (unsigned)(c == 2) << b;
    w3 |= (unsigned)(c == 3) << b;
  }
  unsigned* out = bm + (long long)p * 4 * NB + m;
  out[0] = w0;
  out[NB] = w1;
  out[2LL * NB] = w2;
  out[3LL * NB] = w3;
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// Words idx0 .. idx0 + R of the bitmap plane of code tc (zero for a code
// that matches nothing, past the plane, or above the band's last word).
template <int R>
__device__ __forceinline__ void load_words(unsigned (&raw)[R + 1], const unsigned* bmp, int tc,
                                           int idx0, int NB, int W, int w0) {
  const bool ok = tc >= 0 && tc < 4;
  const unsigned* pl = bmp + (long long)(ok ? tc : 0) * NB;
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    const int i = idx0 + r;
    raw[r] = (ok && w0 + r <= W && i < NB) ? __ldg(pl + i) : 0u;
  }
}

// The boundary masks of word r of a lane in K5's boundary phase (b0 = k - j
// >= 0): `low` covers band lanes 0..b0, `bnd` is lane b0 alone. rel is
// b0's word less the lane's first word.
struct Boundary {
  int rel;
  unsigned lowb, bndb;
  __device__ __forceinline__ unsigned low(int r) const {
    return r < rel ? kFull : (r == rel ? lowb : 0u);
  }
  __device__ __forceinline__ unsigned bnd(int r) const { return r == rel ? bndb : 0u; }
};

// One column j of banded Myers on the lane's R words (b0 = k - j). kBnd: the
// boundary phase j <= k, where the NW boundary row lies at band lane b0 and
// the lanes below it are virtual; otherwise the anchor follows word 0. Bits
// above the band's top lane only ever move up (carries, the up-shift), so
// they are left unmasked; the slide brings the top lane its fixed +1 (the
// row entering the band) at word trel of the lane (the band's last word less
// the lane's first).
template <int R, bool kBnd>
__device__ __forceinline__ void myers_column(unsigned (&vp)[R], unsigned (&vn)[R],
                                             const unsigned (&eq)[R], int lane, int b0,
                                             int trel, unsigned topbit, bool bit1, int& a) {
  const Boundary bd{kBnd ? (b0 >> 5) - lane * R : 0, kBnd ? (2u << (b0 & 31)) - 1u : 0u,
                    kBnd ? 1u << (b0 & 31) : 0u};
  const unsigned nob0m = kBnd && b0 >= 1 ? kFull : 0u;
  // the anchor's vertical part, from the state before the column (lane 0;
  // bit 1 lies in the band unless the band is one lane wide)
  const int da = bit1 ? (int)((vp[0] >> 1) & 1u) - (int)((vn[0] >> 1) & 1u) : 0;
  // the slide's seam: bit 0 of the next lane's first word, VP in bit 0 and
  // VN in bit 1
  unsigned up = __shfl_down_sync(kFull, (vp[0] & 1u) | (vn[0] << 1), 1);
  if (lane == 31) up = 0u;
  unsigned vps[R], vns[R], x[R], part[R], gb[R], pb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    unsigned s = __funnelshift_r(vp[r], r + 1 < R ? vp[r + 1] : up, 1);
    unsigned t = __funnelshift_r(vn[r], r + 1 < R ? vn[r + 1] : up >> 1, 1);
    if (r == trel) {
      s |= topbit;
      t &= ~topbit;
    }
    unsigned xr = eq[r] | t;
    if (kBnd) {
      const unsigned low = bd.low(r);
      s &= ~low;
      xr &= ~low;
    }
    vps[r] = s;
    vns[r] = t;
    x[r] = xr;
    part[r] = (xr & s) + s;
    gb[r] = part[r] < s ? 1u << r : 0u;
    pb[r] = part[r] == kFull ? 1u << r : 0u;
  }
  const unsigned cm = lane_carries<R>(gb, pb, lane);
  unsigned d00 = 0, hp0 = 0, hn0 = 0, hpp = 0, hnp = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned d0 = ((part[r] + ((cm >> r) & 1u)) ^ vps[r]) | x[r];
    unsigned hp = vns[r] | ~(d0 | vps[r]);
    unsigned hn = d0 & vps[r];
    if (kBnd) {  // the boundary row: +1
      hp |= bd.bnd(r);
      hn &= ~bd.bnd(r);
    }
    if (r == 0) {
      d00 = d0;
      hp0 = hp;
      hn0 = hn;
    } else {
      const unsigned hpsh = __funnelshift_l(hpp, hp, 1), hnsh = __funnelshift_l(hnp, hn, 1);
      unsigned nvp = hnsh | ~(d0 | hpsh), nvn = d0 & hpsh;
      if (kBnd) {  // w >= 1 here
        const unsigned lowx = bd.low(r) & ~bd.bnd(r), nob0 = bd.bnd(r) & nob0m;
        nvp &= ~(lowx | nob0);
        nvn = (nvn & ~lowx) | lowx | nob0;
      }
      vp[r] = nvp;
      vn[r] = nvn;
    }
    hpp = hp;
    hnp = hn;
  }
  if (!kBnd && lane == 0) a += da + (int)(hp0 & 1u) - (int)(hn0 & 1u);
  // the up-shift's seam: bit 31 of the lane below's last word, HP in bit 0
  // and HN in bit 31; above lane 0 lies the out-of-band cell, +1
  unsigned below = __shfl_up_sync(kFull, (hpp >> 31) | (hnp & 0x80000000u), 1);
  if (lane == 0) below = 1u;
  const unsigned hpsh = (hp0 << 1) | (below & 1u), hnsh = __funnelshift_l(below, hn0, 1);
  unsigned nvp = hnsh | ~(d00 | hpsh), nvn = d00 & hpsh;
  if (kBnd) {
    // virtual lanes strictly below the boundary keep the -1 ramp; the
    // boundary lane's own vertical delta is -1
    const unsigned lowx = bd.low(0) & ~bd.bnd(0), nob0 = bd.bnd(0) & nob0m;
    const unsigned not0 = lane == 0 ? ~1u : kFull;
    nvp &= ~(lowx | nob0);
    nvn = (nvn & ~lowx) | (lowx & not0) | nob0;
  }
  vp[0] = nvp;
  vn[0] = nvn;
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
    myers_warp_kernel(const int* __restrict__ t,      // [P, Lt] compact codes
                      const int* __restrict__ tlens,  // [P]
                      const unsigned* __restrict__ bm,  // [P, 4, NB], off = k + 1
                      unsigned* __restrict__ cvp,     // [P, W] captured VP
                      unsigned* __restrict__ cvn,     // [P, W] captured VN
                      int* __restrict__ ca,           // [P] captured anchor
                      int P, int Lt, int k, int W, int NB) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const int Bw = 2 * k + 1, topw = (Bw - 1) >> 5, w0 = lane * R;
  const unsigned topbit = 1u << ((Bw - 1) & 31);
  const int tl = tlens[p];
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;  // -1: never captured
  const int* tp = t + (long long)p * Lt;
  const unsigned* bmp = bm + (long long)p * 4 * NB;
  // column 0: anchor k, a -1 ramp below row 0 (lanes 1..k), +1 above
  unsigned vp[R], vn[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w0 + r;
    const unsigned lm = lowmask(w, Bw - 1), km = lowmask(w, k);
    vp[r] = ~km & lm;
    vn[r] = km & ~lowmask(w, 0) & lm;
  }
  int a = k;
  // the target codes of columns 1..32 and 33..64 (t index j - 1 in slot
  // (j - 1) & 31), and the bitmap words of column 1
  int tcur = lane < n ? __ldg(tp + lane) : -1;
  int tnxt = 32 + lane < n ? __ldg(tp + 32 + lane) : -1;
  unsigned raw[R + 1];
  if (n >= 1) load_words<R>(raw, bmp, __shfl_sync(kFull, tcur, 0), w0, NB, W, w0);
  for (int j = 1; j <= n; ++j) {
    unsigned eq[R];
    const int s = j & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) eq[r] = __funnelshift_r(raw[r], raw[r + 1], s);
    // column j + 1: its code (t index j) and its words, a column ahead
    if ((j & 31) == 0) {
      tcur = tnxt;
      tnxt = j + 32 + lane < n ? __ldg(tp + j + 32 + lane) : -1;
    }
    const int tcn = __shfl_sync(kFull, tcur, j & 31);
    if (j < n) load_words<R>(raw, bmp, tcn, ((j + 1) >> 5) + w0, NB, W, w0);
    if (j <= k)
      myers_column<R, true>(vp, vn, eq, lane, k - j, topw - w0, topbit, Bw >= 2, a);
    else
      myers_column<R, false>(vp, vn, eq, lane, k - j, topw - w0, topbit, Bw >= 2, a);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w0 + r;
    if (w < W) {  // the band's lanes only
      const unsigned lm = n < 0 ? 0u : lowmask(w, Bw - 1);
      cvp[(long long)p * W + w] = vp[r] & lm;
      cvn[(long long)p * W + w] = vn[r] & lm;
    }
  }
  if (lane == 0) ca[p] = a;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// Warp g runs segment g % nseg of pair g / nseg: output columns [e_s, e_e)
// (ends index e = target column e + 1), e_s = (g % nseg) * S. Under HW the
// segment starts fresh, D(i, j0) = i (column 0's state), at
// j0 = max(0, e_s - 2 q_len), and that is exact for every output column:
//   1. D(q_len, j) <= q_len, since an alignment may start at j itself;
//   2. an alignment of value d spans at most q_len + d <= 2 q_len target
//      columns (each column is a query row's match or mismatch, or an
//      insertion that costs 1);
//   3. so an optimal alignment ending at column j >= j0 + 2 q_len starts at
//      or after j0, and a sweep with a free target prefix from j0 finds it;
//      it never finds less, since its alignments are alignments of the whole.
// SHW fixes the start at column 0 and runs one segment (nseg = 1, j0 = 0).
template <int R>
__global__ void __launch_bounds__(32 * kWarps)
    semi_warp_kernel(const int* __restrict__ qlens,  // [P]
                     const int* __restrict__ t,      // [P, Lt] compact codes
                     const unsigned* __restrict__ bm,  // [P, 4, W], off = 0
                     int* __restrict__ ends,         // [P, Lt]
                     int P, int Lt, int W, unsigned hp0, int nseg, int S) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (long long)P * nseg) return;  // the whole warp
  const int p = (int)(g / nseg), e_s = (int)(g % nseg) * S;
  const int e_e = min(Lt, e_s + S);
  const int ql = qlens[p];
  const int j0 = max(0, e_s - 2 * ql);
  const int* tp = t + (long long)p * Lt;
  int* ep = ends + (long long)p * Lt;
  const int w0 = lane * R;
  unsigned pq0[R], pq1[R], pq2[R], pq3[R], vp[R], vn[R];
  const unsigned* bmp = bm + (long long)p * 4 * W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = w0 + r < W;
    pq0[r] = in ? __ldg(bmp + w0 + r) : 0u;
    pq1[r] = in ? __ldg(bmp + W + w0 + r) : 0u;
    pq2[r] = in ? __ldg(bmp + 2 * W + w0 + r) : 0u;
    pq3[r] = in ? __ldg(bmp + 3 * W + w0 + r) : 0u;
    vp[r] = kFull;  // column j0: all +1
    vn[r] = 0u;
  }
  // the end row's word, its owner and bit (q_len - 1); without one the
  // score stays q_len
  const int hot_w = ql > 0 ? (ql - 1) >> 5 : -1;
  const bool has_hot = hot_w >= 0 && hot_w < W;
  const int hot_lane = has_hot ? hot_w / R : 0, hot_r = has_hot ? hot_w % R : -1;
  const int hot_b = (ql - 1) & 31;
  int score = ql, buf = 0;
  // the target codes of columns j0 + 1 .. j0 + 64 (t index j in slot
  // (j - j0) & 31), and the code of the first, read a column ahead
  int tcur = j0 + lane < e_e ? __ldg(tp + j0 + lane) : -1;
  int tnxt = j0 + 32 + lane < e_e ? __ldg(tp + j0 + 32 + lane) : -1;
  int tcn = __shfl_sync(kFull, tcur, 0);
  for (int j = j0; j < e_e; ++j) {
    const int i = j - j0;
    const int tc = tcn;
    if ((i & 31) == 31) {
      tcur = tnxt;
      tnxt = j + 33 + lane < e_e ? __ldg(tp + j + 33 + lane) : -1;
    }
    tcn = __shfl_sync(kFull, tcur, (i + 1) & 31);
    unsigned eq[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      eq[r] = tc == 0 ? pq0[r] : tc == 1 ? pq1[r] : tc == 2 ? pq2[r] : tc == 3 ? pq3[r] : 0u;
    // the end score: the owner's delta to every lane; lane e & 31 keeps
    // column e's, and 32 columns go out in one store
    score += sd_warp::semi_column<R>(vp, vn, eq, lane, hp0, hot_lane, hot_r, hot_b);
    if (j >= e_s) {
      if ((j & 31) == lane) buf = score;
      if ((j & 31) == 31 || j == e_e - 1) {
        const int base = j & ~31;
        if (base + lane <= j) ep[base + lane] = buf;
      }
    }
  }
}

template <int R>
int myers_launch(const void* q, const void* qlens, const void* t, const void* tlens, void* bm,
                 void* cvp, void* cvn, void* ca, int P, int Lq, int Lt, int k, int W, int NB,
                 cudaStream_t st) {
  const long long cells = (long long)P * NB;
  peq_bitmaps_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(
      (const int*)q, (const int*)qlens, (unsigned*)bm, P, Lq, k + 1, NB);
  int err = (int)cudaGetLastError();
  if (err) return err;
  myers_warp_kernel<R><<<(P + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
      (const int*)t, (const int*)tlens, (const unsigned*)bm, (unsigned*)cvp, (unsigned*)cvn,
      (int*)ca, P, Lt, k, W, NB);
  return (int)cudaGetLastError();
}

template <int R>
int semi_launch(const void* q, const void* qlens, const void* t, void* bm, void* ends, int P,
                int Lq, int Lt, int W, int hp0, int nseg, int S, cudaStream_t st) {
  const long long cells = (long long)P * W;
  peq_bitmaps_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(
      (const int*)q, (const int*)qlens, (unsigned*)bm, P, Lq, 0, W);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long warps = (long long)P * nseg;
  semi_warp_kernel<R><<<(unsigned)((warps + kWarps - 1) / kWarps), 32 * kWarps, 0, st>>>(
      (const int*)qlens, (const int*)t, (const unsigned*)bm, (int*)ends, P, Lt, W,
      hp0 ? 1u : 0u, nseg, S);
  return (int)cudaGetLastError();
}

template <int R>
int semi_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, semi_warp_kernel<R>,
                                                             32 * kWarps, 0);
}

}  // namespace

#define SD_R_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// K5's warp route: q [P, Lq], t [P, Lt] int32 compact codes; bm a [P, 4, NB]
// int32 scratch for the bitmaps, NB >= (k + Lq + 1 + 31) / 32 + 1; out cvp,
// cvn [P, W], ca [P]. W = ceil((2k + 1) / 32) <= 512.
extern "C" int sd_myers_warp(const void* q, const void* qlens, const void* t, const void* tlens,
                             void* bm, void* cvp, void* cvn, void* ca, int P, int Lq, int Lt,
                             int k, int W, int NB, void* stream) {
  if (P <= 0) return 0;
  if (k < 0 || W != (2 * k + 1 + 31) / 32 || W > 32 * kMaxR || NB < (k + Lq + 32) / 32 + 1)
    return (int)cudaErrorInvalidValue;
  const int R = (W + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
#define SD_MYERS_CASE(RR) \
  case RR:                \
    return myers_launch<RR>(q, qlens, t, tlens, bm, cvp, cvn, ca, P, Lq, Lt, k, W, NB, st);
  switch (R) {
    SD_R_CASES(SD_MYERS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_MYERS_CASE
}

// K6's warp route: q [P, Lq], t [P, Lt] int32 compact codes; bm a [P, 4, W]
// int32 scratch; ends [P, Lt]. W = max(1, ceil(Lq / 32)) <= 512. nseg
// segments of S columns a pair (S a multiple of 32, nseg * S >= Lt), only
// under HW (hp0 = 0); nseg = 1 runs the whole target in one warp.
extern "C" int sd_semi_warp(const void* q, const void* qlens, const void* t, void* bm, void* ends,
                            int P, int Lq, int Lt, int W, int hp0, int nseg, int S,
                            void* stream) {
  if (P <= 0 || Lt <= 0) return 0;
  if (W < 1 || W > 32 * kMaxR || nseg < 1 || (long long)nseg * S < Lt ||
      (nseg > 1 && (hp0 || S % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  const int R = (W + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
#define SD_SEMI_CASE(RR) \
  case RR:               \
    return semi_launch<RR>(q, qlens, t, bm, ends, P, Lq, Lt, W, hp0, nseg, S, st);
  switch (R) {
    SD_R_CASES(SD_SEMI_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_SEMI_CASE
}

// Blocks of K6's warp kernel at W words that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its registers); each
// block is kWarps warps.
extern "C" int sd_semi_warp_occupancy(int W, int* blocks) {
  const int R = (W + 31) / 32;
#define SD_OCC_CASE(RR) \
  case RR:              \
    return semi_occupancy<RR>(blocks);
  switch (R) {
    SD_R_CASES(SD_OCC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_OCC_CASE
}
