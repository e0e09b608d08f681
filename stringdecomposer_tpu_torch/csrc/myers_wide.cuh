// Device functions of bit-parallel Myers as a pipeline of register stages a
// block, shared by K3's wide route (hw_filter.cu, hw_wide_kernel) and K6's
// (banded.cu, semi_wide_kernel): thread s is stage s and holds kWideR
// consecutive 32-row words of VP and VN in registers. At step t it steps
// column t - s on its words (stage_column) and hands the next stage its
// link, the add's carry out and the HP / HN bits of its top row (hand_up).
// Each kernel keeps its own Peq source and its score rule.

#pragma once

#include <cuda_runtime.h>

#include "myers_warp.cuh"

namespace sd_wide {

constexpr int kWideR = 8;            // words a stage (thread)
constexpr int kWideMaxStages = 512;  // stages a band (threads a block; 128 registers a
                                     // thread, no spill)

// One column of a stage's kWideR words (word r holds rows 32 r .. 32 r + 31
// of the stage): VP and VN advance in place given the column's Peq words.
// `link` enters with the carry into the stage's first word (bit 0) and the
// HP / HN bits of the row below it (bits 1, 2), and leaves with the same out
// of its last word. Returns the column's change of the score at bit hot_b
// of word hot_r (0 when hot_r is none of the stage's words).
__device__ __forceinline__ int stage_column(unsigned (&vp)[kWideR], unsigned (&vn)[kWideR],
                                            const unsigned (&eq)[kWideR], unsigned& link,
                                            int hot_r, int hot_b) {
  unsigned x[kWideR], a[kWideR], sum[kWideR], cout;
#pragma unroll
  for (int r = 0; r < kWideR; ++r) {
    x[r] = eq[r] | vn[r];
    a[r] = x[r] & vp[r];
  }
  // sum = a + vp over the 8 words with the link's carry in, through the
  // hardware carry flag (adding 0xffffffff to a carry of 0 or 1 sets it)
  asm("{\n\t"
      ".reg .u32 c;\n\t"
      "add.cc.u32 c, %9, 0xffffffff;\n\t"
      "addc.cc.u32 %0, %10, %18;\n\t"
      "addc.cc.u32 %1, %11, %19;\n\t"
      "addc.cc.u32 %2, %12, %20;\n\t"
      "addc.cc.u32 %3, %13, %21;\n\t"
      "addc.cc.u32 %4, %14, %22;\n\t"
      "addc.cc.u32 %5, %15, %23;\n\t"
      "addc.cc.u32 %6, %16, %24;\n\t"
      "addc.cc.u32 %7, %17, %25;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "}"
      : "=r"(sum[0]), "=r"(sum[1]), "=r"(sum[2]), "=r"(sum[3]), "=r"(sum[4]), "=r"(sum[5]),
        "=r"(sum[6]), "=r"(sum[7]), "=r"(cout)
      : "r"(link & 1u), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(vp[0]), "r"(vp[1]), "r"(vp[2]), "r"(vp[3]), "r"(vp[4]),
        "r"(vp[5]), "r"(vp[6]), "r"(vp[7]));
  unsigned hpp = (link & 2u) << 30, hnp = (link & 4u) << 29, hph = 0, hnh = 0;
#pragma unroll
  for (int r = 0; r < kWideR; ++r) {
    const unsigned d0 = (sum[r] ^ vp[r]) | x[r];
    const unsigned hp = vn[r] | ~(d0 | vp[r]);
    const unsigned hn = d0 & vp[r];
    if (r == hot_r) {
      hph = hp;
      hnh = hn;
    }
    const unsigned hpsh = __funnelshift_l(hpp, hp, 1), hnsh = __funnelshift_l(hnp, hn, 1);
    vp[r] = hnsh | ~(d0 | hpsh);
    vn[r] = d0 & hpsh;
    hpp = hp;
    hnp = hn;
  }
  link = cout | ((hpp >> 31) << 1) | ((hnp >> 31) << 2);
  return (int)((hph >> hot_b) & 1u) - (int)((hnh >> hot_b) & 1u);
}

// The link of the stage below for the next step's column, given this
// stage's `link` out of step `step`: up a lane by a shuffle, from lane 31 to
// the next warp's lane 0 through the double-buffered shared slot `hand`,
// one barrier a step. Stage 0 gets 0 (its kernel supplies its own link).
// Every thread of the block calls it at every step.
__device__ __forceinline__ unsigned hand_up(unsigned link,
                                            unsigned (&hand)[2][kWideMaxStages / 32],
                                            int step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned up = __shfl_up_sync(sd_warp::kFull, link, 1);
  if (lane == 31) hand[step & 1][warp] = link;
  __syncthreads();
  return lane > 0 ? up : warp > 0 ? hand[step & 1][warp - 1] : 0u;
}

}  // namespace sd_wide
