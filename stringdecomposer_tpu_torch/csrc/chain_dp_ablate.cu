// A: the K1 ablation kernels, for timing only (their outputs are knowingly
// not K1's).
//
// Replaces scripts/ablate_chain.py::make_kernel (the pallas_call at :194,
// reached through `run`), which takes K1's production kernel apart by
// dropping one cost centre at a time. Here each variant is one of the two
// bodies that carry K1's main path, instantiated with one cost centre
// removed by a compile-time flag (chain_dp_variant.cuh), int32 state:
//   - the lanes body (chain_dp_lanes.cuh, the shared route), at the bench's
//     form <int, 6, kRegRows>: L = 161..192 (6 cells a lane), M <= 32 rows
//     in registers, one a warp;
//   - the cluster body (chain_dp_cluster.cuh, the large route), at the
//     bench's form <int, 6, kRowsDense, false>: L = 192, R > 32 rows a block
//     in shared memory, cs blocks a window as the wrapper's plan gives.
// The variants:
//   nochain  a row's chain score is its own end cell at i-1, one shuffle
//            from the lane that owns it: no chain max, no parity buffer
//            writes or remote stores, no per-position barrier (JAX's
//            group_max passthrough)
//   ladder4  the pair scan over the 32 lane totals stops after 4 or 2
//   ladder2  doubling steps (JAX's cut ladders)
//   noemit   end / spend reach device memory only at the last position
//   noshift  diag reads the cell's own value and pointer at i-1 in place of
//            the upper-left one (JAX's dp_sh, sp_sh = dp, sp)
// The base variant is K1's own production launch of each body
// (sd_chain_dp_lanes, sd_chain_dp_cluster), so it is not instantiated here.
// JAX's subroll, unroll8 and hoist are TPU formulations of base's own
// function and have no separate form on the card.
//
// What bounds each variant is what bounds K1's body: one SM's integer issue
// a position (the lanes body), plus the cluster exchange and barrier (the
// cluster body). The difference between base's time and a variant's is
// what that cost centre costs the body.

#include "chain_dp_cluster.cuh"

namespace {

constexpr int kAblateC = 6;  // the bench's rows: 180 bp monomers padded to L = 192

template <int kVariant>
int launch_variant(int large, int cs, int R, const void* windows, const void* mono,
                   long long mono_bstride, const void* mono_lens, long long lens_bstride,
                   const void* dp0, void* end, void* spend, int B, int W, int M, int L, int ins,
                   int dele, int mismatch, int match, void* stream) {
  if (!large)
    return launch_lanes_k<int, kAblateC, kRegRows, kVariant>(windows, mono, mono_bstride,
                                                             mono_lens, lens_bstride, dp0, end,
                                                             spend, B, W, M, L, ins, dele,
                                                             mismatch, match, stream);
  const GridExchange none = {nullptr, nullptr, 1};
  return launch_cluster_k<int, kAblateC, kRowsDense, false, kVariant>(
      nullptr, cs, R, windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, end, spend, B,
      W, M, L, ins, dele, mismatch, match, none, stream);
}

}  // namespace

// variant: kNoChain .. kNoShift of chain_dp_variant.cuh's Variant. large = 0:
// the lanes body (cs, R unused), the arguments as sd_chain_dp_lanes' with
// state_bytes 4, at 160 < L <= 192 and M <= 32; large = 1: the cluster body,
// as sd_chain_dp_cluster's, at L = 192 and R > 32. Other shapes are refused.
extern "C" int sd_chain_dp_ablate(int variant, int large, int cs, int R, const void* windows,
                                  const void* mono, long long mono_bstride,
                                  const void* mono_lens, long long lens_bstride, const void* dp0,
                                  void* end, void* spend, int B, int W, int M, int L, int ins,
                                  int dele, int mismatch, int match, void* stream) {
  const bool form = large ? L == 32 * kAblateC && R > 32 && cs >= 1 && cs <= kClusterMax &&
                                (long long)(cs - 1) * R < M && M <= (long long)cs * R &&
                                cluster_smem_bytes(M, L, R, 4) <= kSmemLimit
                          : (L + 31) / 32 == kAblateC && M >= 1 && M <= 32;
  if (!form) return (int)cudaErrorInvalidValue;
#define SD_ABLATE_CASE(V)                                                                   \
  case V:                                                                                   \
    return launch_variant<V>(large, cs, R, windows, mono, mono_bstride, mono_lens,          \
                             lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch, \
                             match, stream);
  switch (variant) {
    SD_ABLATE_CASE(kNoChain)
    SD_ABLATE_CASE(kLadder4)
    SD_ABLATE_CASE(kLadder2)
    SD_ABLATE_CASE(kNoEmit)
    SD_ABLATE_CASE(kNoShift)
  }
#undef SD_ABLATE_CASE
  return (int)cudaErrorInvalidValue;
}
