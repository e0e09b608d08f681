// Device functions of bit-parallel Myers a warp per pair, shared by K6's
// warp route (myers_warp.cu, semi_warp_kernel) and K3's warp route
// (hw_filter.cu, hw_warp_kernel): lane l owns the R consecutive 32-row words
// l*R .. l*R + R - 1 of VP and VN in registers, the addition's carry crosses
// the lanes by two ballots and an add, and the up-shift's seam by one
// __shfl_up_sync. myers_warp.cu says why.

#pragma once

#include <cuda_runtime.h>

namespace sd_warp {

constexpr unsigned kFull = 0xffffffffu;

// The carries of the warp's addition part = a + b over all its words, from
// each lane's R per-word sums `part` (mod 2^32): bit r of the result is the
// carry into the lane's word r. gb / pb enter as the words' generate and
// propagate bits, 1 << r where word r overflowed / is all ones (the two are
// exclusive). The lane's own words are added as R-bit masks: with A = G | P
// over the words, (A + G + c) ^ A ^ G holds the carries given the carry c
// into word 0, and bit R of A + G is the lane's carry out with none
// entering. Across lanes the same identity runs on the ballots: bit l of
// (A + G) ^ A ^ G, A = G | P over the lanes, is the carry into lane l (none
// into lane 0).
template <int R>
__device__ __forceinline__ unsigned lane_carries(unsigned (&gb)[R], unsigned (&pb)[R], int lane) {
#pragma unroll
  for (int s = 1; s < R; s <<= 1) {
#pragma unroll
    for (int r = 0; r + s < R; r += 2 * s) {
      gb[r] |= gb[r + s];
      pb[r] |= pb[r + s];
    }
  }
  const unsigned gm = gb[0], am = gm | pb[0];
  const unsigned G = __ballot_sync(kFull, ((am + gm) >> R) & 1u);
  const unsigned A = G | __ballot_sync(kFull, pb[0] == (1u << R) - 1u);
  const unsigned c = (((A + G) ^ A ^ G) >> lane) & 1u;
  return (am + gm + c) ^ am ^ gm;
}

// One target column of full-height Myers over the warp's words (row i of the
// query is global bit i - 1): VP and VN advance in place, given the column's
// Peq words `eq`, with hp0 the horizontal delta shifted in at row 0 (HW 0,
// SHW 1). Returns, on every lane, the column's change of the score at row
// hot: bit hot_b of word hot_r of lane hot_lane (0 when hot_r < 0).
template <int R>
__device__ __forceinline__ int semi_column(unsigned (&vp)[R], unsigned (&vn)[R],
                                           const unsigned (&eq)[R], int lane, unsigned hp0,
                                           int hot_lane, int hot_r, int hot_b) {
  unsigned x[R], part[R], gb[R], pb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = eq[r] | vn[r];
    part[r] = (x[r] & vp[r]) + vp[r];
    gb[r] = part[r] < vp[r] ? 1u << r : 0u;
    pb[r] = part[r] == kFull ? 1u << r : 0u;
  }
  const unsigned cm = lane_carries<R>(gb, pb, lane);
  unsigned d00 = 0, hpw0 = 0, hnw0 = 0, hpp = 0, hnp = 0, hph = 0, hnh = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned d0 = ((part[r] + ((cm >> r) & 1u)) ^ vp[r]) | x[r];
    const unsigned hp = vn[r] | ~(d0 | vp[r]);
    const unsigned hn = d0 & vp[r];
    if (r == hot_r) {
      hph = hp;
      hnh = hn;
    }
    if (r == 0) {
      d00 = d0;
      hpw0 = hp;
      hnw0 = hn;
    } else {
      const unsigned hpsh = __funnelshift_l(hpp, hp, 1), hnsh = __funnelshift_l(hnp, hn, 1);
      vp[r] = hnsh | ~(d0 | hpsh);
      vn[r] = d0 & hpsh;
    }
    hpp = hp;
    hnp = hn;
  }
  // HP in bit 0, HN in bit 31
  unsigned below = __shfl_up_sync(kFull, (hpp >> 31) | (hnp & 0x80000000u), 1);
  if (lane == 0) below = hp0;
  const unsigned hpsh = (hpw0 << 1) | (below & 1u), hnsh = __funnelshift_l(below, hnw0, 1);
  vp[0] = hnsh | ~(d00 | hpsh);
  vn[0] = d00 & hpsh;
  // the owner's delta to every lane
  const int delta = (int)((hph >> hot_b) & 1u) - (int)((hnh >> hot_b) & 1u);
  return __shfl_sync(kFull, delta, hot_lane);
}

}  // namespace sd_warp
