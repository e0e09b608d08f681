// A: the K1 ablation kernels, for timing only (their outputs are knowingly
// not K1's).
//
// Replaces scripts/ablate_chain.py::make_kernel (reached through `run`).
// Each variant is the SAME kernel body as K1 (chain_dp.cuh), instantiated
// with one cost centre removed by a compile-time flag, on both routes, with
// the int32 state:
//   nochain  the chain score of a row is its own end cell at i-1: no cross-row
//            max and no per-position barriers (JAX's group_max passthrough)
//   ladder4  both warp scans stop after 4 doubling steps, and the carry
//   ladder2  across 32-cell chunks is dropped (JAX's cut ladders)
//   noemit   only the last position's end / spend are written
//   noshift  diag reads the cell's own previous value and pointer in place of
//            the upper-left one (JAX's dp_sh, sp_sh = dp, sp)
// The base variant is K1's own production instantiation (sd_chain_dp in
// chain_dp.cu), so it is not instantiated here. JAX's subroll, unroll8 and
// hoist are TPU formulations of base's own function and have no separate form
// on the card.
//
// What bounds each variant is what bounds K1 (chain_dp.cuh): latency per read
// position. The differences between the variants' times are what K1's
// barriers, scans, emit and shift each cost.

#include "chain_dp.cuh"

namespace {

template <int kVariant>
int launch_route(int large, const void* windows, const void* mono, long long mono_bstride,
                 const void* mono_lens, long long lens_bstride, void* dp0, void* sp_scratch,
                 void* end, void* spend, int B, int W, int M, int L, int ins, int dele,
                 int mismatch, int match, void* stream) {
  if (large)
    return launch_chain_dp<true, int, kVariant>(windows, mono, mono_bstride, mono_lens,
                                                lens_bstride, dp0, sp_scratch, end, spend, B,
                                                W, M, L, ins, dele, mismatch, match, stream);
  return launch_chain_dp<false, int, kVariant>(windows, mono, mono_bstride, mono_lens,
                                               lens_bstride, dp0, sp_scratch, end, spend, B,
                                               W, M, L, ins, dele, mismatch, match, stream);
}

}  // namespace

// variant: kNoChain .. kNoShift of chain_dp.cuh's Variant; the other
// arguments as sd_chain_dp's with state_bytes 4.
extern "C" int sd_chain_dp_ablate(int variant, int large, const void* windows,
                                  const void* mono, long long mono_bstride,
                                  const void* mono_lens, long long lens_bstride, void* dp0,
                                  void* sp_scratch, void* end, void* spend, int B, int W,
                                  int M, int L, int ins, int dele, int mismatch, int match,
                                  void* stream) {
#define SD_ABLATE_CASE(V)                                                                    \
  case V:                                                                                    \
    return launch_route<V>(large, windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, \
                           sp_scratch, end, spend, B, W, M, L, ins, dele, mismatch, match,   \
                           stream);
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
