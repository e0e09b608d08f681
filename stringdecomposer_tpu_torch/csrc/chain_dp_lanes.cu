// K1's lanes body (chain_dp_lanes.cuh): the shared route at L <= 512. Its
// own source, so that nvcc builds its 96 instances (int32 and int16 state,
// C = 1..16, three row forms) beside the other sources', not after them.

#include "chain_dp_lanes.cuh"

// K1's shared route at L <= 512 (the lanes body): dp0 is only read.
// state_bytes is 4 (int32) or 2 (int16): dp0, end and spend are of that type.
extern "C" int sd_chain_dp_lanes(int state_bytes, const void* windows, const void* mono,
                                 long long mono_bstride, const void* mono_lens,
                                 long long lens_bstride, const void* dp0, void* end, void* spend,
                                 int B, int W, int M, int L, int ins, int dele, int mismatch,
                                 int match, void* stream) {
  if (L < 1 || L > 32 * kLanesMaxC) return (int)cudaErrorInvalidValue;
  if (state_bytes == 4)
    return launch_lanes<int>(windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, end,
                             spend, B, W, M, L, ins, dele, mismatch, match, stream);
  if (state_bytes == 2)
    return launch_lanes<int16_t>(windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, end,
                                 spend, B, W, M, L, ins, dele, mismatch, match, stream);
  return (int)cudaErrorInvalidValue;
}
